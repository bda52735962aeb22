"""Offline LMDB dataset builder of the port (the port's copy of
``mrn_tpu/tools/create_lmdb.py``, reference: tools/create_lmdb_dataset.py).

Converts image+label ground-truth lists into train/test LMDB pairs with the
reference's layout and policies:
- keys image-%09d / label-%09d (1-based) + num-samples;
- image validity check: the port's cv2 view (``data.image.imdecode``), as
  JAX's ``cv2.imdecode``: bytes cv2 cannot read are rejected (a cut-off
  file; TIFF in LZMA or ZSTD, 2- or 4-bit gray, 12-, 32- or 64-bit samples),
  a valid file of a form the port does not decode (JPEG 2000, AVIF, PNM,
  TGA, ICO, ...; arithmetic, lossless, 12-bit or YCCK JPEG) raises (it
  would raise in training too).  The RLE, BITFIELDS and core-header BMPs and the
  GIFs without a colour table that cv2 reads and the port's cv2 view does
  not model are judged by Pillow's view (``data.image.decode``);
- 9:1 shuffled train/test split via a reshuffled 10-slot assignment
  (is_test, create_lmdb_dataset.py:13-14, 90-149);
- per-language character lexicon emitted as dict.txt next to the train LMDB
  (write_txt, create_lmdb_dataset.py:49-62).

Backed by the native lmdbx writer, so outputs are standard LMDB files.
The data path's first step, word crops out of a scene tree, is
``tools/crop_by_word.py``; ``tools/analysis.py`` is the per-character
accuracy report.

    python3 -m mrn_tpu_torch.tools.create_lmdb --input_path IMAGES \
        --gt_file gt.txt --output_path train/Latin --output_path2 test/Latin
"""

from __future__ import annotations

import argparse
import functools
import os
import random
import shutil
from typing import Callable, Iterable, List, Optional, Tuple

import numpy as np

from mrn_tpu_torch.data import image as image_codec
from mrn_tpu_torch.data.lmdb_store import LmdbReader, LmdbWriter

__all__ = ["check_image_valid", "write_dict_txt", "create_dataset",
           "create_train_test_dataset", "read_gt_file",
           "create_from_lmdb_train_test_dataset", "create_synth_mlt_dataset",
           "create_dataset_with_valid_testset", "create_synthetic_dataset"]


def check_image_valid(image_bin: bytes) -> bool:
    if image_bin is None:
        return False
    try:
        try:
            img = image_codec.imdecode(image_bin, image_codec.IMREAD_COLOR)
        except image_codec.UnsupportedImage:
            img = image_codec.decode(image_bin)
    except image_codec.CorruptImage:
        return False
    return img.shape[0] * img.shape[1] != 0


def write_dict_txt(lexicon: Iterable[str], out_path_base: str):
    """dict.txt: one character per line."""
    path = out_path_base + ".txt"
    if os.path.exists(path):
        os.remove(path)
    with open(path, "w", encoding="utf-8") as f:
        for ch in lexicon:
            f.write(ch)
            f.write("\n")


def read_gt_file(gt_file: str) -> List[Tuple[str, Optional[str], str]]:
    """Parses 'imagepath,language,label' lines (the MLT gt format,
    create_lmdb_dataset.py:100-106); falls back to 'imagepath<space>label'."""
    out = []
    with open(gt_file, "r", encoding="utf-8-sig") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if "," in line and len(line.split(",", 2)) == 3:
                image, lan, label = line.split(",", 2)
                out.append((image, lan, label))
            else:
                parts = line.split(" ", 1)
                if len(parts) == 2:
                    out.append((parts[0], None, parts[1]))
    return out


def _fresh_dir(path: str):
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path, exist_ok=True)


def create_dataset(input_path: str, gt_file: str, output_path: str,
                   check_valid: bool = True, lan_lmdb: Optional[str] = None,
                   map_size: int = 80 * 2 ** 30):
    """Single LMDB (no split) + dict.txt (createDataset,
    create_lmdb_dataset.py:275-350)."""
    _fresh_dir(output_path)
    writer = LmdbWriter(output_path, map_size=map_size)
    lexicon = set()
    cnt = 1
    for image, lan, label in read_gt_file(gt_file):
        if lan_lmdb is not None and lan != lan_lmdb:
            continue
        image_path = os.path.join(input_path, image)
        if not os.path.exists(image_path):
            print(f"{image_path} does not exist")
            continue
        with open(image_path, "rb") as f:
            image_bin = f.read()
        if check_valid and not check_image_valid(image_bin):
            print(f"{image_path} is not a valid image")
            continue
        writer.put(b"image-%09d" % cnt, image_bin)
        writer.put(b"label-%09d" % cnt, label.encode())
        writer.put(b"imagepath-%09d" % cnt, image_path.encode())
        lexicon.update(label)
        cnt += 1
    writer.put(b"num-samples", str(cnt - 1).encode())
    writer.commit()
    write_dict_txt(sorted(lexicon), os.path.join(output_path, "dict"))
    print(f"Created dataset with {cnt - 1} samples")
    return cnt - 1


def create_train_test_dataset(input_path: str, gt_file: str, output_path: str,
                              output_path2: str, check_valid: bool = True,
                              lan_lmdb: Optional[str] = None,
                              map_size: int = 80 * 2 ** 30, seed=None):
    """Train/test LMDB pair with the 9:1 reshuffled-slot split + dict.txt
    (create_train_test_Dataset, create_lmdb_dataset.py:64-174)."""
    _fresh_dir(output_path)
    _fresh_dir(output_path2)
    train_w = LmdbWriter(output_path, map_size=map_size)
    test_w = LmdbWriter(output_path2, map_size=map_size)
    rng = random.Random(seed)
    rad_num = list(range(10))
    rng.shuffle(rad_num)
    lexicon = set()
    cnt, cnt_train, cnt_test = 1, 1, 1

    for image, lan, label in read_gt_file(gt_file):
        if lan_lmdb is not None and lan != lan_lmdb:
            continue
        image_path = os.path.join(input_path, image)
        if not os.path.exists(image_path):
            print(f"{image_path} does not exist")
            continue
        with open(image_path, "rb") as f:
            image_bin = f.read()
        if check_valid and not check_image_valid(image_bin):
            print(f"{image_path} is not a valid image")
            continue

        if rad_num[cnt % 10] == 1:  # is_test
            test_w.put(b"image-%09d" % cnt_test, image_bin)
            test_w.put(b"label-%09d" % cnt_test, label.encode())
            cnt_test += 1
        else:
            train_w.put(b"image-%09d" % cnt_train, image_bin)
            train_w.put(b"label-%09d" % cnt_train, label.encode())
            cnt_train += 1
        if cnt % 10 == 0:
            rng.shuffle(rad_num)
        lexicon.update(label)
        cnt += 1

    train_w.put(b"num-samples", str(cnt_train - 1).encode())
    test_w.put(b"num-samples", str(cnt_test - 1).encode())
    train_w.commit()
    test_w.commit()
    write_dict_txt(sorted(lexicon), os.path.join(output_path, "dict"))
    print(f"Created dataset with {cnt_train - 1} train samples")
    print(f"Created dataset with {cnt_test - 1} test samples")
    return cnt_train - 1, cnt_test - 1


def create_from_lmdb_train_test_dataset(input_path: str, output_path: str,
                                        output_path2: str,
                                        map_size: int = 80 * 2 ** 30,
                                        seed=None):
    """Re-split an EXISTING LMDB into a train/test pair with the 9:1
    reshuffled-slot policy + dict.txt next to the train output
    (create_from_lmdb_train_test_Dataset, create_lmdb_dataset.py:176-273)."""
    _fresh_dir(output_path)
    _fresh_dir(output_path2)
    reader = LmdbReader(input_path)
    n_samples = int(reader.get(b"num-samples"))
    print(f"total sampler:{n_samples}")

    train_w = LmdbWriter(output_path, map_size=map_size)
    test_w = LmdbWriter(output_path2, map_size=map_size)
    rng = random.Random(seed)
    rad_num = list(range(10))
    rng.shuffle(rad_num)
    lexicon = set()
    cnt, cnt_train, cnt_test = 1, 1, 1

    for i in range(n_samples):
        label = reader.get(b"label-%09d" % (i + 1))
        image = reader.get(b"image-%09d" % (i + 1))
        if rad_num[cnt % 10] == 1:  # is_test
            test_w.put(b"image-%09d" % cnt_test, image)
            test_w.put(b"label-%09d" % cnt_test, label)
            cnt_test += 1
        else:
            train_w.put(b"image-%09d" % cnt_train, image)
            train_w.put(b"label-%09d" % cnt_train, label)
            cnt_train += 1
        if cnt % 10 == 0:
            rng.shuffle(rad_num)
        lexicon.update(label.decode("utf-8"))
        cnt += 1

    train_w.put(b"num-samples", str(cnt_train - 1).encode())
    test_w.put(b"num-samples", str(cnt_test - 1).encode())
    train_w.commit()
    test_w.commit()
    print(f"Created dataset with {cnt_train - 1} train samples")
    print(f"Created dataset with {cnt_test - 1} test samples")
    write_dict_txt(sorted(lexicon), os.path.join(output_path, "dict"))
    return cnt_train - 1, cnt_test - 1


def create_synth_mlt_dataset(image_paths: List[str], labels: List[str],
                             output_path: str, check_valid: bool = True,
                             map_size: int = 80 * 2 ** 30):
    """Single LMDB from parallel image-path/label lists (synthetic MLT crops;
    createSynthMLTDataset, create_lmdb_dataset.py:351-424)."""
    _fresh_dir(output_path)
    writer = LmdbWriter(output_path, map_size=map_size)
    lexicon = set()
    cnt = 1
    for image_path, label in zip(image_paths, labels):
        if not os.path.exists(image_path):
            print(f"{image_path} does not exist")
            continue
        with open(image_path, "rb") as f:
            image_bin = f.read()
        if check_valid and not check_image_valid(image_bin):
            print(f"{image_path} is not a valid image")
            continue
        writer.put(b"image-%09d" % cnt, image_bin)
        writer.put(b"label-%09d" % cnt, label.encode())
        writer.put(b"imagepath-%09d" % cnt, image_path.encode())
        lexicon.update(label)
        cnt += 1
    writer.put(b"num-samples", str(cnt - 1).encode())
    writer.commit()
    write_dict_txt(sorted(lexicon), os.path.join(output_path, "dict"))
    print(f"Created dataset with {cnt - 1} samples")
    return cnt - 1


def create_dataset_with_valid_testset(input_path: str, gt_file: str,
                                      output_path: str, dataset_name: str,
                                      validset_percent: int = 10,
                                      testset_percent: int = 0,
                                      random_seed: int = 1111,
                                      check_valid: bool = True,
                                      map_size: int = 30 * 2 ** 30):
    """Split one tab-separated gt list into training/validation[/evaluation]
    LMDBs under output_path/<split>/<dataset_name>, emitting the per-split gt
    side files gt_{train,valid,test}.txt
    (createDataset_with_ValidTestset, create_lmdb_dataset.py:427-556)."""
    train_path = os.path.join(output_path, "training", dataset_name)
    valid_path = os.path.join(output_path, "validation", dataset_name)
    _fresh_dir(train_path)
    _fresh_dir(valid_path)
    gt_train_path = gt_file.replace(".txt", "_train.txt")
    gt_valid_path = gt_file.replace(".txt", "_valid.txt")
    if testset_percent != 0:
        test_path = os.path.join(output_path, "evaluation", dataset_name)
        _fresh_dir(test_path)
        gt_test_path = gt_file.replace(".txt", "_test.txt")

    with open(gt_file, "r", encoding="utf-8-sig") as data:
        datalist = data.readlines()
    rng = random.Random(random_seed)
    rng.shuffle(datalist)

    n_samples = len(datalist)
    num_valid = int(n_samples * validset_percent / 100.0)
    num_test = int(n_samples * testset_percent / 100.0)
    num_train = n_samples - num_valid - num_test
    print(f"# Train dataset: {num_train}, # valid datast: {num_valid}, "
          f"and # test datast: {num_test}")

    writer = LmdbWriter(train_path, map_size=map_size)
    data_log = open(gt_train_path, "w", encoding="utf-8")
    cnt = 1
    counts = {"train": 0, "valid": 0, "test": 0}
    split = "train"
    for i in range(n_samples):
        # Split transitions happen BEFORE processing sample i, so a skipped
        # (missing/invalid) sample can never jump a boundary, and num-samples
        # records the count actually written — the reference (520-544) checks
        # after a possible `continue` and stamps the planned counts instead.
        if i == num_train:
            print(f"# Train dataset: {counts['train']} is finished")
            writer.put(b"num-samples", str(counts["train"]).encode())
            writer.commit()
            data_log.close()
            writer = LmdbWriter(valid_path, map_size=map_size)
            data_log = open(gt_valid_path, "w", encoding="utf-8")
            cnt = 1
            split = "valid"
        if i == num_train + num_valid and num_test != 0:
            print(f"# Valid dataset: {counts['valid']} is finished")
            writer.put(b"num-samples", str(counts["valid"]).encode())
            writer.commit()
            data_log.close()
            writer = LmdbWriter(test_path, map_size=map_size)
            data_log = open(gt_test_path, "w", encoding="utf-8")
            cnt = 1
            split = "test"

        data_log.write(datalist[i])
        image, label = datalist[i].strip("\n").split("\t")
        image_path = os.path.join(input_path, image)
        if not os.path.exists(image_path):
            print(f"{image_path} does not exist")
            continue
        with open(image_path, "rb") as f:
            image_bin = f.read()
        if check_valid and not check_image_valid(image_bin):
            print(f"{image_path} is not a valid image")
            continue
        writer.put(b"image-%09d" % cnt, image_bin)
        writer.put(b"label-%09d" % cnt, label.encode())
        writer.put(b"imagepath-%09d" % cnt, image_path.encode())
        counts[split] += 1
        cnt += 1

    writer.put(b"num-samples", str(counts[split]).encode())
    print(f"# {split} dataset: {counts[split]} is finished")
    writer.commit()
    data_log.close()
    return counts["train"], counts["valid"], counts["test"]


def create_synthetic_dataset(output_path: str, alphabet: str, n: int, seed: int,
                             heights=(24, 48), widths=(48, 320), max_len: int = 4,
                             char_to_idx: Optional[dict] = None,
                             encode: Optional[Callable] = None) -> int:
    """An LMDB of ``n`` synthetic crops (``data.synthetic``'s bit renderer
    over ``char_to_idx``, default the alphabet's order) of words of 1 to
    ``max_len`` characters at natural sizes, heights and widths drawn
    uniformly from the given ranges (inclusive), every draw from
    ``default_rng(seed)``; ``encode(rgba) -> bytes`` (default PNG,
    ``data.image.encode_png`` at zlib level 1: the noisy crops compress no
    better at 6, in twice the time) writes each crop; ``dict.txt`` beside
    it."""
    from mrn_tpu_torch.data.synthetic import synth_word_image_bits

    encode = encode or functools.partial(image_codec.encode_png, level=1)
    char_to_idx = char_to_idx or {ch: i for i, ch in enumerate(alphabet)}
    rng = np.random.default_rng(seed)
    _fresh_dir(output_path)
    writer = LmdbWriter(output_path, map_size=1 << 34)
    chars, lexicon = list(alphabet), set()
    for cnt in range(1, n + 1):
        word = "".join(rng.choice(chars, size=int(rng.integers(1, max_len + 1))))
        h = int(rng.integers(heights[0], heights[1] + 1))
        w = int(rng.integers(widths[0], widths[1] + 1))
        writer.put(b"image-%09d" % cnt, encode(synth_word_image_bits(word, char_to_idx, h, w,
                                                                     rng)))
        writer.put(b"label-%09d" % cnt, word.encode())
        lexicon.update(word)
    writer.put(b"num-samples", str(n).encode())
    writer.commit()
    write_dict_txt(sorted(lexicon), os.path.join(output_path, "dict"))
    return n


def main():
    parser = argparse.ArgumentParser(description="Build LMDB crop datasets")
    parser.add_argument("--input_path", required=True)
    parser.add_argument("--gt_file", required=True)
    parser.add_argument("--output_path", required=True)
    parser.add_argument("--output_path2", default=None,
                        help="test LMDB path (enables the 9:1 split)")
    parser.add_argument("--lan", default=None, help="keep only this language")
    parser.add_argument("--no_check", action="store_true")
    args = parser.parse_args()
    if args.output_path2:
        create_train_test_dataset(args.input_path, args.gt_file,
                                  args.output_path, args.output_path2,
                                  check_valid=not args.no_check,
                                  lan_lmdb=args.lan)
    else:
        create_dataset(args.input_path, args.gt_file, args.output_path,
                       check_valid=not args.no_check, lan_lmdb=args.lan)


if __name__ == "__main__":
    main()
