"""LMDB crop data of the port against the JAX package's, bit for bit:

- each side's LMDB files (``native/lmdbx/lmdbx.cpp``, built by each
  package on its own) read by the other;
- ``LmdbDataset`` / ``hierarchical_dataset`` items (PNG and JPEG crops at
  natural sizes, a corrupt record, an over-long label) and log text; the
  port's uint8 crop, normalised on the device by ``_device_images``,
  equals JAX's ``ResizeNormalize`` float32;
- the ``DatasetManager`` + ``ValDataset`` stream over a 2-task LMDB tree
  with MRN's rehearsal memory, with and without the device bank;
- ``bank_dataset``'s bank and ``create_lmdb``'s train / test split.
"""

import io
import os
import random
import struct

import numpy as np
import PIL.Image
import pytest
import torch

from mrn_tpu.config import default_options as jax_options
from mrn_tpu.data import dataset as jax_dataset
from mrn_tpu.data import lmdb_store as jax_store
from mrn_tpu.data.manager import DatasetManager as JaxManager
from mrn_tpu.data.manager import ValDataset as JaxValDataset
from mrn_tpu.data.transform import ResizeNormalize as JaxResizeNormalize
from mrn_tpu.tools import create_lmdb as jax_create
from mrn_tpu.train.learners.base import BaseLearner as JaxBase
from mrn_tpu.train.learners.mrn import MRN as JaxMRN
from mrn_tpu_torch.config import default_options
from mrn_tpu_torch.data import dataset, image, lmdb_store
from mrn_tpu_torch.data.manager import DatasetManager, ValDataset
from mrn_tpu_torch.data.transform import ResizeNormalize, TextAugment, build_transform
from mrn_tpu_torch.tools import create_lmdb
from mrn_tpu_torch.train.learners.mrn import MRN


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch's CPU ops on one thread here: beside the other test workers,
    more threads oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


IMG_H, IMG_W = 32, 64
LANS = ["T0", "T1"]
ALPHABETS = ["abcde", "fghij"]
SEED = 111


def _mixed_encoder():
    """Cycles through the port's PNG writer, PIL's PNG and PIL's 4:2:0 and
    4:4:4 JPEG."""
    state = {"n": 0}

    def encode(rgba):
        state["n"] += 1
        kind = state["n"] % 4
        if kind == 0:
            return image.encode_png(rgba)
        buf = io.BytesIO()
        im = PIL.Image.fromarray(rgba)
        if kind == 1:
            im.save(buf, "PNG")
        else:
            im.convert("RGB").save(buf, "JPEG", quality=85, subsampling=0 if kind == 2 else 2)
        return buf.getvalue()
    return encode


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("lmdb_tree")
    for split, n, seed in (("train", 24, 0), ("test", 10, 50)):
        for i, (lan, alphabet) in enumerate(zip(LANS, ALPHABETS)):
            create_lmdb.create_synthetic_dataset(str(root / split / lan), alphabet, n, seed + i,
                                                 heights=(20, 40), widths=(40, 160),
                                                 encode=_mixed_encoder())
    return root


def _opts(**kw):
    common = dict(dict(il="mrn", memory="random", memory_num=8, batch_size=4, imgH=IMG_H,
                       imgW=IMG_W, manual_seed=SEED, batch_max_length=8, lan_list=LANS), **kw)
    return default_options(**common), jax_options(**common)


def _normed(batch):
    """The device-side normalisation of a uint8 batch, on the CPU."""
    return ((torch.as_tensor(batch).float() / 255.0 - 0.5) / 0.5).numpy()


# ------------------------------------------------------------ LMDB files
def test_each_side_reads_the_others_files(tmp_path):
    values = {b"num-samples": b"3", b"big": bytes(range(256)) * 40}
    values.update({b"label-%09d" % i: f"w{i}".encode() for i in range(1, 4)})
    for writer_mod, reader_mod, name in ((lmdb_store, jax_store, "port"),
                                         (jax_store, lmdb_store, "jax")):
        path = str(tmp_path / name)
        w = writer_mod.LmdbWriter(path)
        for k, v in values.items():
            w.put(k, v)
        w.commit()
        r = reader_mod.LmdbReader(path)
        assert len(r) == len(values)
        for k, v in values.items():
            assert r.get(k) == v
        assert r.get(b"missing") is None


# --------------------------------------------------------------- datasets
def _odd_lmdb(path, jpeg_progressive=False):
    """An LMDB with a good crop, a truncated one, an over-long label and,
    optionally, a progressive JPEG (which only PIL decodes)."""
    rng = np.random.default_rng(3)
    crop = rng.integers(0, 256, (25, 70, 4), np.uint8)
    good = image.encode_png(crop)
    buf = io.BytesIO()
    PIL.Image.fromarray(crop).convert("RGB").save(buf, "JPEG", progressive=True)
    records = [(good, "abc"), (good[:len(good) // 2], "de"), (good, "x" * 9)]
    if jpeg_progressive:
        records.append((buf.getvalue(), "prog"))
    w = lmdb_store.LmdbWriter(path)
    w.put(b"num-samples", str(len(records)).encode())
    for i, (data, label) in enumerate(records, 1):
        w.put(b"image-%09d" % i, data)
        w.put(b"label-%09d" % i, label.encode())
    w.commit()


def test_lmdb_dataset_items_match_jax(tree, tmp_path):
    """Keys from 1, long labels out, corrupt bytes as JAX's dummy, every
    crop equal to JAX's after its resize; normalised, equal to JAX's
    ``ResizeNormalize`` bitwise."""
    opt, jopt = _opts()
    _odd_lmdb(str(tmp_path / "odd"))
    to_jax = JaxResizeNormalize((IMG_W, IMG_H))
    for path in (str(tree / "train" / "T0"), str(tmp_path / "odd")):
        got, ref = dataset.LmdbDataset(path, opt), jax_dataset.LmdbDataset(path, jopt)
        assert got.filtered_index_list == ref.filtered_index_list and len(got) == len(ref)
        crops, want = [], []
        for i in range(len(ref)):
            (g, gl), (r, rl) = got[i], ref[i]
            assert gl == rl
            assert g.dtype == np.uint8 and g.shape == (IMG_H, IMG_W, 4)
            np.testing.assert_array_equal(
                g, np.asarray(r.resize((IMG_W, IMG_H), PIL.Image.BICUBIC)))
            crops.append(ResizeNormalize((IMG_W, IMG_H))(g))
            want.append(to_jax(r))
        assert np.asarray(crops).dtype == np.uint8
        assert _normed(np.stack(crops)).tobytes() == np.stack(want).astype(np.float32).tobytes()
    odd = dataset.LmdbDataset(str(tmp_path / "odd"), opt)
    assert [lb for _, lb in (odd[0], odd[1])] == ["abc", "[dummy_label]"]
    assert not odd[1][0].any()


def test_device_images_normalise_as_jax(tree, tmp_path):
    """The learner's own ``_device_images`` on a uint8 LMDB batch."""
    opt, jopt = _opts(output_dir=str(tmp_path), data_log=str(tmp_path / "d.txt"))
    learner = MRN(opt, device="cpu")
    got = dataset.LmdbDataset(str(tree / "test" / "T1"), opt)
    ref = jax_dataset.LmdbDataset(str(tree / "test" / "T1"), jopt)
    batch = np.stack([got[i][0] for i in range(len(got))])
    want = np.stack([JaxResizeNormalize((IMG_W, IMG_H))(ref[i][0]) for i in range(len(ref))])
    assert learner._device_images(batch).numpy().tobytes() == want.tobytes()


FORMS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_forms")


def _pil_bytes(fmt, **kw):
    buf = io.BytesIO()
    rgb = np.random.default_rng(8).integers(0, 256, (20, 50, 3), np.uint8)
    PIL.Image.fromarray(rgb).save(buf, fmt, **kw)
    return buf.getvalue()


def _thunderscan_tiff(h=6, w=10):
    """A 4-bit gray ThunderScan TIFF (every sample a raw code), which Pillow
    reads and the port names and refuses."""
    data = bytes(0xC0 | v % 16 for v in range(h * w))
    tags = [(256, 3, w), (257, 3, h), (258, 3, 4), (259, 3, 32809), (262, 3, 1), (273, 4, 8),
            (277, 3, 1), (278, 3, h), (279, 4, len(data))]
    pad = b"\0" * (len(data) % 2)
    return (b"II" + struct.pack("<HI", 42, 8 + len(data) + len(pad)) + data + pad +
            struct.pack("<H", len(tags)) +
            b"".join(struct.pack("<HHII" if ty == 4 else "<HHIHH", tag, ty, 1, *(
                (v,) if ty == 4 else (v, 0))) for tag, ty, v in tags) + b"\0" * 4)


def test_unsupported_crop_raises_where_jax_decodes(tmp_path):
    """Crops in every form the port decodes beyond baseline JPEG and 8-bit
    PNG (progressive, 4:1:1, 4:4:0, CMYK, EXIF JPEG; 16-bit and interlaced
    PNG; GIF; BMP) give JAX's ``LmdbDataset`` items and ``ResizeNormalize``
    tensors bitwise, and so do WebP, TIFF and ZSTD TIFF; a ThunderScan
    TIFF, which JAX decodes, still raises."""
    opt, jopt = _opts()
    _odd_lmdb(str(tmp_path / "odd"), jpeg_progressive=True)
    names = sorted(n for n in os.listdir(os.path.join(FORMS, "crops")) if n != "labels.txt")
    records = [(open(os.path.join(FORMS, "crops", n), "rb").read(), "abc") for n in names]
    w = lmdb_store.LmdbWriter(str(tmp_path / "forms"))
    w.put(b"num-samples", str(len(records)).encode())
    for i, (data, label) in enumerate(records, 1):
        w.put(b"image-%09d" % i, data)
        w.put(b"label-%09d" % i, label.encode())
    w.commit()
    to_jax = JaxResizeNormalize((IMG_W, IMG_H))
    for path in (str(tmp_path / "odd"), str(tmp_path / "forms")):
        got, ref = dataset.LmdbDataset(path, opt), jax_dataset.LmdbDataset(path, jopt)
        assert got.filtered_index_list == ref.filtered_index_list
        for i in range(len(ref)):
            (g, gl), (r, rl) = got[i], ref[i]
            assert gl == rl
            assert _normed(ResizeNormalize((IMG_W, IMG_H))(g)[None]).tobytes() == \
                to_jax(r)[None].astype(np.float32).tobytes()
    assert len(dataset.LmdbDataset(str(tmp_path / "forms"), opt)) == len(names) == 19
    for form in ("TIFF", "WebP", "ZSTD", "ThunderScan"):
        w = lmdb_store.LmdbWriter(str(tmp_path / form))
        w.put(b"num-samples", b"1")
        w.put(b"image-000000001", {"ZSTD": lambda: _pil_bytes("TIFF", compression="zstd"),
                                   "ThunderScan": _thunderscan_tiff}.get(
                                       form, lambda: _pil_bytes(form.upper()))())
        w.put(b"label-000000001", b"ab")
        w.commit()
        ref = jax_dataset.LmdbDataset(str(tmp_path / form), jopt)[0]
        assert ref[1] == "ab"
        if form != "ThunderScan":
            got = dataset.LmdbDataset(str(tmp_path / form), opt)[0]
            assert got[1] == "ab"
            assert _normed(ResizeNormalize((IMG_W, IMG_H))(got[0])[None]).tobytes() == \
                to_jax(ref[0])[None].astype(np.float32).tobytes()
            continue
        with pytest.raises(image.UnsupportedImage, match=r"TIFF \(ThunderScan\)"):
            dataset.LmdbDataset(str(tmp_path / form), opt)[0]


@pytest.mark.parametrize("select", ["/", ["T1"], ["T0", "T1"]])
def test_hierarchical_dataset_matches_jax(tree, select):
    opt, jopt = _opts()
    got, glog = dataset.hierarchical_dataset(str(tree / "train"), opt, select_data=select)
    ref, rlog = jax_dataset.hierarchical_dataset(str(tree / "train"), jopt, select_data=select)
    assert glog == rlog and len(got) == len(ref)
    assert [d.root for d in got.datasets] == [d.root for d in ref.datasets]


def test_raw_dataset_matches_jax(tree, tmp_path):
    folder = tmp_path / "crops"
    (folder / "sub").mkdir(parents=True)
    src = dataset.LmdbDataset(str(tree / "test" / "T0"), _opts()[0])
    for i in range(3):
        raw = src.env.get(b"image-%09d" % (i + 1))
        ext = ".png" if raw.startswith(image.PNG_MAGIC) else ".jpg"
        (folder / ("sub" if i == 1 else "") / f"c{i}{ext}").write_bytes(raw)
    (folder / "note.txt").write_text("not a crop")
    opt, jopt = _opts()
    got, ref = dataset.RawDataset(str(folder), opt), jax_dataset.RawDataset(str(folder), jopt)
    assert got.image_path_list == ref.image_path_list and len(got) == 3
    for i in range(3):
        (g, gp), (r, rp) = got[i], ref[i]
        assert gp == rp
        np.testing.assert_array_equal(g, np.asarray(r.resize((IMG_W, IMG_H), PIL.Image.BICUBIC)))


def test_raw_dataset_over_new_forms_matches_jax():
    """RawDataset over the fixtures' crop folder (its jpg and png files:
    progressive, 4:1:1, 4:4:0, CMYK, EXIF JPEG; 16-bit and interlaced PNG)
    gives JAX's ``ResizeNormalize`` tensors bitwise."""
    opt, jopt = _opts()
    folder = os.path.join(FORMS, "crops")
    got, ref = dataset.RawDataset(folder, opt), jax_dataset.RawDataset(folder, jopt)
    assert got.image_path_list == ref.image_path_list and len(got) == 11
    to_jax = JaxResizeNormalize((IMG_W, IMG_H))
    for i in range(len(got)):
        (g, gp), (r, rp) = got[i], ref[i]
        assert gp == rp
        assert _normed(ResizeNormalize((IMG_W, IMG_H))(g)[None]).tobytes() == \
            to_jax(r)[None].astype(np.float32).tobytes()


def test_bank_dataset_matches_jax(tree):
    opt, jopt = _opts()
    got_bank, ref_bank = dataset.DeviceImageBank(), jax_dataset.DeviceImageBank()
    for lan in LANS:
        path = str(tree / "test" / lan)
        g = dataset.bank_dataset(dataset.LmdbDataset(path, opt), opt, got_bank)
        r = jax_dataset.bank_dataset(jax_dataset.LmdbDataset(path, jopt), jopt, ref_bank)
        assert (g.start, list(g.labels)) == (r.start, list(r.labels))
    assert np.concatenate(got_bank.chunks).tobytes() == np.concatenate(ref_bank.chunks).tobytes()
    with pytest.raises(ValueError, match="Aug"):
        dataset.bank_dataset(dataset.LmdbDataset(path, opt), opt.replace(Aug="Blur5"), got_bank)


def test_augmentation_is_not_ported():
    """``build_transform`` dispatches as JAX's: TextAugment for any
    ``Aug`` but ``"None"`` and ``"ABINet"``, the ABINet chain for that, the
    resize in test mode; the augmentations need explicit generators, and
    a bank index still passes through."""
    gens = dict(rng=random.Random(SEED), np_rng=np.random.RandomState(SEED))
    opt, _ = _opts(Aug="Blur5-Crop90")
    assert isinstance(build_transform(opt, mode="train", **gens), TextAugment)
    assert callable(build_transform(opt.replace(Aug="ABINet"), mode="train", **gens))
    assert not isinstance(build_transform(opt.replace(Aug="ABINet"), mode="train", **gens),
                          (TextAugment, ResizeNormalize))
    with pytest.raises(ValueError, match="rng"):
        build_transform(opt, mode="train")
    assert isinstance(build_transform(opt, mode="test"), ResizeNormalize)
    assert isinstance(build_transform(opt.replace(Aug="None"), mode="train"), ResizeNormalize)
    assert ResizeNormalize((IMG_W, IMG_H))(np.int32(7)) == 7
    assert build_transform(opt, mode="train", **gens)(np.int32(7)) == 7


# ----------------------------------------------------------------- stream
class _JaxStub:
    """What the JAX ``MRN.build_rehearsal_memory`` reads of its learner."""
    build_random_current_memory = JaxBase.build_random_current_memory
    reduce_samplers = JaxBase.reduce_samplers

    def __init__(self, opt):
        self.opt, self.np_rng, self.memory_index = opt, np.random.default_rng(opt.manual_seed), []


def _stream(manager, build_memory, val, steps=5):
    """MRN's calls over two tasks: step 0 of each, task 1's memory and its
    indexed batches, then both validation loaders."""
    out = [manager.get_batch() for _ in range(steps)]
    manager.get_dataset(1, memory=None)
    out += [manager.get_batch() for _ in range(steps)]
    build_memory(manager, 1)
    out += [manager.get_batch2() for _ in range(steps)]
    out += list(val.create_dataset())
    out += list(val.create_list_dataset())
    return out


@pytest.mark.parametrize("bank", [False, True])
def test_stream_matches_jax(tree, tmp_path, bank):
    """Images (uint8 normalised on the device against JAX's float32, or
    bank indices with equal banks), labels, router targets, validation
    batches and generator states, bitwise."""
    roots = dict(select_data=[str(tree / "train")], valid_datas=[str(tree / "test")])
    opt, jopt = _opts(output_dir=str(tmp_path), data_log=str(tmp_path / "d.txt"), **roots)
    if bank:
        opt.image_bank, jopt.image_bank = dataset.DeviceImageBank(), \
            jax_dataset.DeviceImageBank()
    learner, stub = MRN(opt, device="cpu"), _JaxStub(jopt)
    vals = [os.path.join(str(tree / "test"), lan) for lan in LANS]
    got_m, ref_m = DatasetManager(opt), JaxManager(jopt)
    got_m.init_start(opt, opt.select_data, None, 0)
    ref_m.init_start(jopt, jopt.select_data, None, 0)
    got = _stream(got_m, learner.build_rehearsal_memory, ValDataset(vals, opt))
    ref = _stream(ref_m, lambda m, t: JaxMRN.build_rehearsal_memory(stub, m, t),
                  JaxValDataset(vals, jopt))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        # an eval batch's padded rows (zeros of each side's dtype) are not read
        n = g[2] if isinstance(r[-1], int) else len(r[1])
        if bank:
            assert g[0].dtype == np.int32 and g[0][:n].tobytes() == r[0][:n].tobytes()
        else:
            assert g[0].dtype == np.uint8
            assert _normed(g[0][:n]).tobytes() == np.asarray(r[0][:n], np.float32).tobytes()
        assert list(g[1]) == list(r[1])
        if len(r) > 2:
            assert np.asarray(g[2]).tobytes() == np.asarray(r[2]).tobytes()
    if bank:
        assert np.concatenate(opt.image_bank.chunks).tobytes() == \
            np.concatenate(jopt.image_bank.chunks).tobytes()
        assert set(opt.image_bank.datasets) == set(jopt.image_bank.datasets)
    assert [np.asarray(ix).tobytes() for ix in learner.memory_index] == \
        [np.asarray(ix).tobytes() for ix in stub.memory_index]
    assert got_m.rng.bit_generator.state == ref_m.rng.bit_generator.state


# ------------------------------------------------------------------- tools
def test_create_lmdb_split_matches_jax(tree, tmp_path):
    """The 9:1 train / test split with its reshuffled 10-slot assignment,
    the 1-based keys and dict.txt equal JAX's; an unreadable file is
    skipped by both."""
    src = dataset.LmdbDataset(str(tree / "train" / "T0"), _opts()[0])
    images = tmp_path / "images"
    images.mkdir()
    lines = []
    for i in range(1, 25):
        name = f"c{i}.img"
        raw = src.env.get(b"image-%09d" % i)
        (images / name).write_bytes(raw if i != 5 else raw[:40])
        lines.append(f"{name},Latin,{src.env.get(b'label-%09d' % i).decode()}")
    gt = tmp_path / "gt.txt"
    gt.write_text("\n".join(lines) + "\n", encoding="utf-8")
    outs = {}
    for mod, name in ((create_lmdb, "port"), (jax_create, "jax")):
        tr, te = str(tmp_path / name / "train"), str(tmp_path / name / "test")
        counts = mod.create_train_test_dataset(str(images), str(gt), tr, te, seed=7)
        outs[name] = (counts, tr, te)
    assert outs["port"][0] == outs["jax"][0] and sum(outs["port"][0]) == 23
    for i in (1, 2):
        got, ref = lmdb_store.LmdbReader(outs["port"][i]), lmdb_store.LmdbReader(outs["jax"][i])
        assert len(got) == len(ref)
        n = int(got.get(b"num-samples"))
        for k in range(1, n + 1):
            for key in (b"image-%09d" % k, b"label-%09d" % k):
                assert got.get(key) == ref.get(key)
    for i in (1,):
        with open(os.path.join(outs["port"][i], "dict.txt"), encoding="utf-8") as f, \
                open(os.path.join(outs["jax"][i], "dict.txt"), encoding="utf-8") as g:
            assert f.read() == g.read()
    assert create_lmdb.read_gt_file(str(gt)) == jax_create.read_gt_file(str(gt))
    assert not create_lmdb.check_image_valid(b"\x89PNG\r\n\x1a\n broken")
