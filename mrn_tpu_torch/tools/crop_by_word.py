"""Offline word-crop extractor of the port (the port's copy of
``mrn_tpu/tools/crop_by_word.py``, reference: tools/crop_by_word.py): crops
padded axis-aligned word boxes out of full scene images using 8-point
quadrilateral ground truth, writing ``imgs/`` + ``label.txt``, the first
step of the data path (scene tree -> word crops -> ``create_lmdb`` ->
training).

No cv2: images are read by ``data.image.imread``, which gives what
``cv2.imread`` gives (``IMREAD_UNCHANGED`` for the stored shape,
``IMREAD_COLOR`` for the BGR pixels the crops come from, EXIF orientation
applied), and each crop is written as an 8-bit RGB PNG, as ``cv2.imwrite``
writes a BGR array.  The JAX tool's behaviour is kept: images and
ground-truth files are paired by position after sorting each list, gts are
read as ``utf-8-sig``, lines with fewer than 10 fields are skipped, crop
bounds are truncated with ``int(np.clip(...))``, and an empty crop is
skipped without using up an index.

    python3 -m mrn_tpu_torch.tools.crop_by_word ROOT [--img_dir imgs]
        [--gt_dir gts] [--out_dir crops] [--nproc 4]
"""

from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
from multiprocessing import Pool
from typing import Dict, List, Tuple

import numpy as np

from mrn_tpu_torch.data import image as image_codec

__all__ = ["crop_img", "load_img_info", "collect_files", "collect_annotations",
           "generate_ann", "main"]


def crop_img(src_img: np.ndarray, box, long_edge_pad_ratio: float = 0.4,
             short_edge_pad_ratio: float = 0.2) -> np.ndarray:
    """Crop a text region given an 8-value quadrangle, padding the long edge
    by 0.4x and the short edge by 0.2x of the font size."""
    assert len(box) == 8
    h, w = src_img.shape[:2]
    xs = np.clip(np.asarray(box[0::2], dtype=float), 0, w)
    ys = np.clip(np.asarray(box[1::2], dtype=float), 0, h)
    box_w = xs.max() - xs.min()
    box_h = ys.max() - ys.min()
    font_size = min(box_h, box_w)
    if box_h < box_w:
        hpad, vpad = long_edge_pad_ratio * font_size, short_edge_pad_ratio * font_size
    else:
        hpad, vpad = short_edge_pad_ratio * font_size, long_edge_pad_ratio * font_size
    left = int(np.clip(xs.min() - hpad, 0, w))
    top = int(np.clip(ys.min() - vpad, 0, h))
    right = int(np.clip(xs.max() + hpad, 0, w))
    bottom = int(np.clip(ys.max() + vpad, 0, h))
    return src_img[top:bottom, left:right]


def load_img_info(files: Tuple[str, str]) -> Dict:
    """Parse one (image, gt) pair: each gt line is
    'x1,y1,...,x4,y4,language,word'; the size is the stored one."""
    img_file, gt_file = files
    img = image_codec.imread(img_file, image_codec.IMREAD_UNCHANGED)
    info = dict(file_name=img_file, height=img.shape[0], width=img.shape[1])
    anno_info = []
    with open(gt_file, encoding="utf-8-sig") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            strs = line.split(",")
            if len(strs) < 10:
                continue
            xy = [float(x) for x in strs[0:8]]
            xs, ys = xy[0::2], xy[1::2]
            # axis-aligned bounds of the quad
            bbox = [min(xs), min(ys), max(xs), min(ys),
                    max(xs), max(ys), min(xs), max(ys)]
            anno_info.append(dict(word=strs[9], bbox=bbox))
    info["anno_info"] = anno_info
    return info


def collect_files(img_dir: str, gt_dir: str) -> List[Tuple[str, str]]:
    """Pair the sorted images with the sorted ground-truth files, by
    position."""
    suffixes = [".png", ".PNG", ".jpg", ".JPG", ".jpeg", ".JPEG"]
    imgs = []
    for s in suffixes:
        imgs.extend(glob.glob(osp.join(img_dir, "*" + s)))
    imgs = sorted(imgs)
    gts = sorted(osp.join(gt_dir, g) for g in os.listdir(gt_dir))
    files = list(zip(imgs, gts))
    assert files, f"No images found in {img_dir}"
    return files


def collect_annotations(files, nproc: int = 1):
    if nproc > 1:
        with Pool(nproc) as pool:
            return pool.map(load_img_info, files)
    return [load_img_info(f) for f in files]


def generate_ann(root_path: str, image_infos, out_dir: str):
    """Write per-word crops to imgs/ and 'imgs/<name> <word>' lines to
    label.txt."""
    dst_image_root = osp.join(out_dir, "imgs")
    os.makedirs(dst_image_root, exist_ok=True)
    lines = []
    for info in image_infos:
        index = 1
        image = image_codec.imread(info["file_name"])
        src_root = osp.splitext(osp.basename(info["file_name"]))[0]
        for anno in info["anno_info"]:
            dst_img = crop_img(image, anno["bbox"])
            if dst_img.size == 0 or min(dst_img.shape[:2]) == 0:
                continue
            name = f"{src_root}_{index}.png"
            index += 1
            with open(osp.join(dst_image_root, name), "wb") as f:
                f.write(image_codec.encode_png(dst_img[:, :, ::-1]))   # BGR -> RGB
            lines.append(f"{osp.basename(dst_image_root)}/{name} {anno['word']}")
    with open(osp.join(out_dir, "label.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + ("\n" if lines else ""))
    return lines


def main(argv=None):
    parser = argparse.ArgumentParser(description="Crop words out of SynthMLT")
    parser.add_argument("root_path", help="SynthMLT root (imgs/ + gts/)")
    parser.add_argument("--img_dir", default="imgs")
    parser.add_argument("--gt_dir", default="gts")
    parser.add_argument("--out_dir", default="crops")
    parser.add_argument("--nproc", type=int, default=4)
    args = parser.parse_args(argv)
    files = collect_files(osp.join(args.root_path, args.img_dir),
                          osp.join(args.root_path, args.gt_dir))
    infos = collect_annotations(files, nproc=args.nproc)
    lines = generate_ann(args.root_path, infos, args.out_dir)
    print(f"wrote {len(lines)} crops to {args.out_dir}")


if __name__ == "__main__":
    main()
