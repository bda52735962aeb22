"""The port's dataset tools (``tools/crop_by_word.py``, ``tools/analysis.py``)
against the JAX package's, on the CPU.

``crop_by_word``: its functions and its CLI on a scene tree of every form
cv2 reads (the fixtures' nine scenes plus 16-bit gray, 16-bit LA, palette
and GIF / BMP content under png and jpg names): the same pairs, infos,
crop names, ``label.txt`` bytes, and crops pixel-equal under cv2's
``IMREAD_UNCHANGED`` and under Pillow.  ``analysis``: the same returns and
log lines.
"""

import importlib.util
import io
import os
import shutil
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import PIL.Image
import pytest

from mrn_tpu.tools import analysis as jax_analysis
from mrn_tpu.tools import crop_by_word as jax_crop
from mrn_tpu_torch.tools import analysis, crop_by_word

ROOT = Path(__file__).resolve().parents[1]
FORMS = ROOT / "tests" / "fixtures" / "torch_forms"
_spec = importlib.util.spec_from_file_location(
    "make_torch_forms_fixtures", ROOT / "scripts" / "make_torch_forms_fixtures.py")
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)


def _pil_save(im, fmt, **kw):
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The fixtures' scene tree plus scenes in the other forms cv2 reads."""
    root = tmp_path_factory.mktemp("scenes")
    shutil.copytree(FORMS / "imgs", root / "imgs")
    shutil.copytree(FORMS / "gts", root / "gts")
    rng = np.random.default_rng(77)
    extra = {}
    img, gt = fx._scene(rng, 80, 120)
    gray = img.mean(axis=2).astype(np.uint16)
    extra["t0_gray16.png"] = (_pil_save(PIL.Image.fromarray(gray * 200 + 7), "PNG"), gt)
    img, gt = fx._scene(rng, 70, 130)
    la = np.stack([img[:, :, 0].astype(np.uint16) * 257, np.full(img.shape[:2], 40000,
                                                                   np.uint16)], 2)
    extra["t1_la16.png"] = (fx.write_png(la, 4, 16, interlace=True), gt)
    img, gt = fx._scene(rng, 75, 110)
    extra["t2_palette4.png"] = (_pil_save(PIL.Image.fromarray(img).quantize(16), "PNG",
                                          bits=4), gt)
    img, gt = fx._scene(rng, 70, 120)
    extra["t3_gif.png"] = (_pil_save(PIL.Image.fromarray(img).quantize(64), "GIF",
                                     transparency=3), gt)
    img, gt = fx._scene(rng, 60, 100)
    extra["t4_bmp.jpg"] = (_pil_save(PIL.Image.fromarray(img), "BMP"), gt)
    for name, (data, gt) in extra.items():
        (root / "imgs" / name).write_bytes(data)
        (root / "gts" / (name.rsplit(".", 1)[0] + ".txt")).write_text(gt, encoding="utf-8")
    return root


def _pairs(tree):
    return [(os.path.basename(i), os.path.basename(g))
            for i, g in crop_by_word.collect_files(str(tree / "imgs"), str(tree / "gts"))]


def test_collect_files_pairs_by_position_as_jax(tree, tmp_path):
    assert crop_by_word.collect_files(str(tree / "imgs"), str(tree / "gts")) == \
        jax_crop.collect_files(str(tree / "imgs"), str(tree / "gts"))
    assert len(_pairs(tree)) == 14
    # names that do not match still pair by position after sorting each list
    (tmp_path / "i").mkdir()
    (tmp_path / "g").mkdir()
    for name in ("b.png", "a.JPG", "c.jpeg", "notes.txt"):
        (tmp_path / "i" / name).write_bytes(b"")
    for name in ("z.txt", "y.txt"):
        (tmp_path / "g" / name).write_text("")
    got = crop_by_word.collect_files(str(tmp_path / "i"), str(tmp_path / "g"))
    assert got == jax_crop.collect_files(str(tmp_path / "i"), str(tmp_path / "g"))
    assert [(os.path.basename(a), os.path.basename(b)) for a, b in got] == \
        [("a.JPG", "y.txt"), ("b.png", "z.txt")]
    (tmp_path / "e").mkdir()
    for module in (crop_by_word, jax_crop):
        with pytest.raises(AssertionError, match="No images found"):
            module.collect_files(str(tmp_path / "e"), str(tmp_path / "g"))


@pytest.mark.parametrize("index", range(14))
def test_load_img_info_matches_jax(tree, index):
    """The stored size (``IMREAD_UNCHANGED``: an EXIF-rotated JPEG is not
    turned), the BOM dropped, short lines skipped, the quads' bounds."""
    pair = crop_by_word.collect_files(str(tree / "imgs"), str(tree / "gts"))[index]
    assert crop_by_word.load_img_info(pair) == jax_crop.load_img_info(pair)


BOXES = [[10, 5, 60, 5, 60, 25, 10, 25], [-20, -5, 30, -5, 30, 40, -20, 40],
         [100.7, 3.2, 260, 3.9, 259.1, 30.5, 101.2, 29.8], [5, 5, 5, 5, 5, 9, 5, 9],
         [300, 300, 400, 300, 400, 350, 300, 350], [20, 10, 28, 10, 28, 70, 20, 70],
         [0, 0, 200, 0, 200, 150, 0, 150], [33.5, 12.5, 34.5, 12.5, 34.5, 13.5, 33.5, 13.5]]


@pytest.mark.parametrize("box", BOXES, ids=range(len(BOXES)))
def test_crop_img_matches_jax(box):
    """Padding by 0.4 / 0.2 of the font size, ``int(np.clip(...))`` bounds;
    boxes past the edges and empty ones."""
    img = np.random.default_rng(1).integers(0, 256, (150, 200, 3), np.uint8)
    got, want = crop_by_word.crop_img(img, box), jax_crop.crop_img(img, box)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    for module in (crop_by_word, jax_crop):
        with pytest.raises(AssertionError):
            module.crop_img(img, box[:6])


def _crops(out):
    names = sorted(os.listdir(out / "imgs"))
    return names, (out / "label.txt").read_bytes()


def test_generate_ann_and_cli_match_jax(tree, tmp_path):
    """The port's CLI (``--nproc 2``: the Pool path) against JAX's
    functions: crop names, ``label.txt`` bytes, and crops equal under cv2's
    ``IMREAD_UNCHANGED`` (BGR) and under Pillow (RGB, as cv2.imwrite
    writes a BGR array)."""
    files = jax_crop.collect_files(str(tree / "imgs"), str(tree / "gts"))
    lines = jax_crop.generate_ann(str(tree), jax_crop.collect_annotations(files, 1),
                                  str(tmp_path / "jax"))
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-m", "mrn_tpu_torch.tools.crop_by_word", str(tree),
                           "--out_dir", str(tmp_path / "port"), "--nproc", "2"],
                          capture_output=True, text=True, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == f"wrote {len(lines)} crops to {tmp_path / 'port'}"
    names, label = _crops(tmp_path / "port")
    assert (names, label) == _crops(tmp_path / "jax")
    assert len(names) == len(lines) == 42
    assert "s4_exif6_1.png" in names and "t0_gray16_3.png" in names
    for name in names:
        port, jax = tmp_path / "port" / "imgs" / name, tmp_path / "jax" / "imgs" / name
        a, b = (cv2.imread(str(p), cv2.IMREAD_UNCHANGED) for p in (port, jax))
        assert a.dtype == b.dtype == np.uint8 and a.shape == b.shape and a.shape[2] == 3
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.asarray(PIL.Image.open(port)),
                                      np.asarray(PIL.Image.open(jax)))
        assert PIL.Image.open(port).mode == PIL.Image.open(jax).mode == "RGB"


def test_generate_ann_in_process_and_pool(tree, tmp_path):
    files = crop_by_word.collect_files(str(tree / "imgs"), str(tree / "gts"))
    one = crop_by_word.collect_annotations(files, nproc=1)
    assert crop_by_word.collect_annotations(files, nproc=2) == one
    lines = crop_by_word.generate_ann(str(tree), one, str(tmp_path / "a"))
    assert lines == jax_crop.generate_ann(str(tree), jax_crop.collect_annotations(files, 1),
                                          str(tmp_path / "b"))
    assert _crops(tmp_path / "a") == _crops(tmp_path / "b")


def test_empty_tree_writes_an_empty_label_file(tmp_path):
    (tmp_path / "imgs").mkdir()
    (tmp_path / "gts").mkdir()
    (tmp_path / "imgs" / "a.png").write_bytes(fx.write_png(np.zeros((4, 4, 3)), 2, 8))
    (tmp_path / "gts" / "a.txt").write_text("1,2,3\n", encoding="utf-8")
    for module, out in ((crop_by_word, "p"), (jax_crop, "j")):
        files = module.collect_files(str(tmp_path / "imgs"), str(tmp_path / "gts"))
        assert module.generate_ann(str(tmp_path), module.collect_annotations(files),
                                   str(tmp_path / out)) == []
    assert (tmp_path / "p" / "label.txt").read_bytes() == (tmp_path / "j" /
                                                            "label.txt").read_bytes() == b""


# ------------------------------------------------------------------ analysis
TEXTS = {"small": ("ab\nb\n", "ab\nbc\ncc\nd\n"),
         "buckets": ("你好\n好\n", "你好\n好你\n好好\n世界\n你\n"),
         "empty": ("", "abc\n"),
         "blank_lines": ("a\n\n", "a\n\nbb\n")}


@pytest.mark.parametrize("case", sorted(TEXTS))
def test_analysis_matches_jax(case, tmp_path):
    true, total = TEXTS[case]
    (tmp_path / "true.txt").write_text(true, encoding="utf-8")
    (tmp_path / "total.txt").write_text(total, encoding="utf-8")
    t, g = str(tmp_path / "true.txt"), str(tmp_path / "total.txt")
    assert analysis.char_frequency(g) == jax_analysis.char_frequency(g)
    assert analysis.char_accuracy(t, g) == jax_analysis.char_accuracy(t, g)
    port_log, jax_log = tmp_path / "logs" / "port.txt", tmp_path / "logs" / "jax.txt"
    for _ in range(2):     # appended, not overwritten
        lines = analysis.char_accuracy_report(t, g, str(port_log))
        assert lines == jax_analysis.char_accuracy_report(t, g, str(jax_log))
    assert port_log.read_bytes() == jax_log.read_bytes()
    assert analysis.char_accuracy_report(t, g) == jax_analysis.char_accuracy_report(t, g)
