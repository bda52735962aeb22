"""``tests/fixtures/torch_tiff/`` is what ``scripts/make_torch_tiff_fixtures.py``
writes, and the port reproduces it: every file's Pillow and cv2 views (the
digests in ``expected.npz``; a view whose library does not read the file
raises ``CorruptImage``), the JAX ``crop_by_word`` run on its scene tree
(TIFF scenes under ``.jpg`` / ``.png`` names), ``create_lmdb``'s check and
output against JAX's, and JAX's ``RawDataset`` over the crops named
``.jpg``.  ``chip_smoke.py`` runs
the same checks on the card's machine."""

import importlib.util
import os
from pathlib import Path

import cv2
import numpy as np
import PIL.Image
import pytest

from mrn_tpu.config import default_options as jax_options
from mrn_tpu.data import dataset as jax_dataset
from mrn_tpu.tools import create_lmdb as jax_create
from mrn_tpu_torch.config import default_options
from mrn_tpu_torch.data import dataset, image, lmdb_store
from mrn_tpu_torch.tools import create_lmdb, crop_by_word

ROOT = Path(__file__).resolve().parents[1]
TIFF = ROOT / "tests" / "fixtures" / "torch_tiff"
_spec = importlib.util.spec_from_file_location(
    "make_torch_tiff_fixtures", ROOT / "scripts" / "make_torch_tiff_fixtures.py")
tx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tx)
EXPECTED = np.load(TIFF / "expected.npz")


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


def test_committed_fixtures_are_what_the_script_writes(tmp_path):
    tx.build(str(tmp_path / "tiff"))
    assert _files(tmp_path / "tiff") == _files(TIFF)
    for name in _files(TIFF):
        if name != "expected.npz":
            assert (tmp_path / "tiff" / name).read_bytes() == (TIFF / name).read_bytes(), name
    fresh = np.load(tmp_path / "tiff" / "expected.npz")
    assert sorted(fresh.files) == sorted(EXPECTED.files)
    for key in EXPECTED.files:
        np.testing.assert_array_equal(fresh[key], EXPECTED[key], err_msg=key)
    total = sum((TIFF / n).stat().st_size for n in _files(TIFF))
    assert total < 480 * 1024


IMAGES = [n for n in _files(TIFF) if n.startswith(("imgs/", "crops/")) and
          not n.endswith(".txt")]
VIEWS = {"pil": image.decode,
         "cv_color": lambda data: image.imdecode(data, image.IMREAD_COLOR),
         "cv_unchanged": lambda data: image.imdecode(data, image.IMREAD_UNCHANGED)}


@pytest.mark.parametrize("name", IMAGES)
def test_port_reproduces_each_fixture(name):
    data = (TIFF / name).read_bytes()
    assert image.image_format(data) == "tiff"
    for which, view in VIEWS.items():
        if f"{name}:{which}" in EXPECTED.files:
            assert tx.forms.digest(view(data)) == EXPECTED[f"{name}:{which}"], which
        else:    # the library gives None or fails: Pillow on a big-endian BigTIFF, cv2 on LZMA
            with pytest.raises(image.CorruptImage):
                view(data)


def test_fixtures_cover_every_form():
    assert len(IMAGES) == 7 + 44
    assert sum(n.endswith((".jpg", ".png")) for n in IMAGES) == 6 + 2
    names = " ".join(IMAGES)
    for form in ("none", "packbits", "lzw", "old_style", "deflate", "lzma", "jpeg_ycbcr420",
                 "tiles", "planar", "fill_order2", "big_endian", "bigtiff", "predictor",
                 "palette", "cmyk", "alpha", "associated", "orientation6", "multi_page",
                 "ccitt_rle", "ccitt_rlew", "g3_1d", "g3_2d", "g4", "int16_signed", "int32",
                 "float32_predictor3", "float64", "gray12", "ycbcr422_lzw", "ycbcr420_none",
                 "ycbcr_tiles", "cielab", "cielab16", "zstd", "g4_page"):
        assert form in names, form
    missing = [k for k in (f"{n}:{w}" for n in IMAGES for w in VIEWS) if k not in EXPECTED.files]
    cv2_none = ["d06_lzma", "d12_gray4", "d13_gray2_fill_order2", "d42_zstd",
                "d43_zstd_float_predictor3"]
    unchanged_only = ["d33_int32_predictor", "d34_float32_predictor3", "d35_float64_big_endian",
                      "d36_gray12"]
    assert sorted(missing) == sorted(
        [f"crops/{n}.tif:{w}" for n in cv2_none for w in ("cv_color", "cv_unchanged")] +
        [f"crops/{n}.tif:cv_color" for n in unchanged_only] +
        # libtiff's RLEW decoder misreads its encoder's word alignment here and
        # fails in Pillow's read; cv2's RGBA read goes on
        ["crops/d27_ccitt_rlew.tif:pil",
         "crops/d35_float64_big_endian.tif:pil", "crops/d38_ycbcr420_none.tif:pil",
         "crops/d41_cielab16_tiles.tif:pil", "imgs/t4_bigtiff_planar.png:pil"])


def test_port_crop_by_word_gives_jax_output(tmp_path):
    crop_by_word.main([str(TIFF), "--out_dir", str(tmp_path), "--nproc", "1"])
    names = sorted(os.listdir(tmp_path / "imgs"))
    assert names == list(EXPECTED["jax:names"]) and len(names) == 18
    assert (tmp_path / "label.txt").read_bytes() == EXPECTED["jax:label"].tobytes()
    for name in names:
        got = image.imdecode((tmp_path / "imgs" / name).read_bytes(), image.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, EXPECTED[f"jax:crop:{name}"], err_msg=name)


def test_imread_fails_on_a_turned_scene_as_cv2(tmp_path):
    """cv2's imread gives None for a TIFF whose Orientation 5-8 changes its
    shape (imdecode turns it), so such a scene stops both tools."""
    data = (TIFF / "crops" / "d23_orientation6.tif").read_bytes()
    path = tmp_path / "turned.jpg"
    path.write_bytes(data)
    for flags in (image.IMREAD_COLOR, image.IMREAD_UNCHANGED):
        assert cv2.imread(str(path), flags) is None
        assert image.imread(str(path), flags) is None
        np.testing.assert_array_equal(image.imdecode(data, flags),
                                      cv2.imdecode(np.frombuffer(data, np.uint8), flags))


@pytest.mark.parametrize("tree", ["torch_forms", "torch_webp", "torch_tiff"])
def test_check_image_valid_matches_jax(tree):
    """create_lmdb's check keeps what JAX's (cv2.imdecode in gray) keeps on
    every scene and crop of the fixture trees: on TIFF the two libraries
    part (cv2 reads no LZMA and no 2- or 4-bit gray); the BMPs whose cv2
    reading the port does not model (RLE, BITFIELDS) fall back to Pillow's
    view, which agrees."""
    root = ROOT / "tests" / "fixtures" / tree
    names = [n for n in _files(root) if n.startswith(("imgs/", "crops/")) and
             not n.endswith(".txt")]
    got = {n: create_lmdb.check_image_valid((root / n).read_bytes()) for n in names}
    assert got == {n: jax_create.check_image_valid((root / n).read_bytes()) for n in names}
    kept = sorted(n.split("/", 1)[1] for n in names if n.startswith("crops/") and got[n])
    if tree == "torch_tiff":
        assert kept == list(EXPECTED["jax:kept"]) and len(kept) == 35
    else:   # chip_smoke.py expects every crop kept where jax:kept is not committed
        assert len(kept) == sum(n.startswith("crops/") for n in names)


def test_create_lmdb_over_tiff_crops_matches_jax(tmp_path):
    """The port's create_dataset over the TIFF word crops writes JAX's
    LMDB: the same 35 of 44 crops (cv2 reads no LZMA, no ZSTD, no 2- or
    4-bit gray, and 12-, 32- and 64-bit samples only under
    IMREAD_UNCHANGED), keys, labels and bytes."""
    crops = TIFF / "crops"
    kept = create_lmdb.create_dataset(str(crops), str(crops / "labels.txt"),
                                      str(tmp_path / "port"))
    want = jax_create.create_dataset(str(crops), str(crops / "labels.txt"),
                                     str(tmp_path / "jax"), map_size=1 << 26)
    assert kept == want == len(EXPECTED["jax:kept"]) == 35
    got, ref = lmdb_store.LmdbReader(str(tmp_path / "port")), \
        lmdb_store.LmdbReader(str(tmp_path / "jax"))
    assert len(got) == len(ref)
    for k in range(1, kept + 1):
        for key in (b"image-%09d" % k, b"label-%09d" % k):
            assert got.get(key) == ref.get(key)


def test_raw_dataset_reads_tiff_named_jpg_as_jax():
    common = dict(imgH=32, imgW=100, batch_max_length=8)
    opt, jopt = default_options(**common), jax_options(**common)
    got = dataset.RawDataset(str(TIFF / "crops"), opt)
    ref = jax_dataset.RawDataset(str(TIFF / "crops"), jopt)
    assert got.image_path_list == ref.image_path_list and len(got) == 2
    for i in range(len(got)):
        (g, gp), (r, rp) = got[i], ref[i]
        assert gp == rp
        np.testing.assert_array_equal(g, np.asarray(r.resize((100, 32), PIL.Image.BICUBIC)))
