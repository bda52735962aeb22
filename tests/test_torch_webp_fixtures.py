"""``tests/fixtures/torch_webp/`` is what ``scripts/make_torch_webp_fixtures.py``
writes, and the port reproduces it: every file's Pillow and cv2 views (the
digests in ``expected.npz``), the JAX ``crop_by_word`` run on its scene
tree (WebP scenes under ``.jpg`` / ``.png`` names), ``create_lmdb``'s
check and JAX's ``RawDataset`` over the crops named ``.jpg``.
``chip_smoke.py`` runs the same checks on the card's machine."""

import importlib.util
import os
from pathlib import Path

import numpy as np
import PIL.Image
import pytest

from mrn_tpu.config import default_options as jax_options
from mrn_tpu.data import dataset as jax_dataset
from mrn_tpu_torch.config import default_options
from mrn_tpu_torch.data import dataset, image
from mrn_tpu_torch.tools import create_lmdb, crop_by_word

ROOT = Path(__file__).resolve().parents[1]
WEBP = ROOT / "tests" / "fixtures" / "torch_webp"
_spec = importlib.util.spec_from_file_location(
    "make_torch_webp_fixtures", ROOT / "scripts" / "make_torch_webp_fixtures.py")
wx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(wx)
EXPECTED = np.load(WEBP / "expected.npz")


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


def test_committed_fixtures_are_what_the_script_writes(tmp_path):
    wx.build(str(tmp_path / "webp"))
    assert _files(tmp_path / "webp") == _files(WEBP)
    for name in _files(WEBP):
        if name != "expected.npz":
            assert (tmp_path / "webp" / name).read_bytes() == (WEBP / name).read_bytes(), name
    fresh = np.load(tmp_path / "webp" / "expected.npz")
    assert sorted(fresh.files) == sorted(EXPECTED.files)
    for key in EXPECTED.files:
        np.testing.assert_array_equal(fresh[key], EXPECTED[key], err_msg=key)
    total = sum((WEBP / n).stat().st_size for n in _files(WEBP))
    assert total < 300 * 1024


IMAGES = [n for n in _files(WEBP) if n.startswith(("imgs/", "crops/")) and
          not n.endswith(".txt")]


@pytest.mark.parametrize("name", IMAGES)
def test_port_reproduces_each_fixture(name):
    data = (WEBP / name).read_bytes()
    assert image.image_format(data) == "webp"
    assert wx.forms.digest(image.decode(data)) == EXPECTED[f"{name}:pil"]
    assert wx.forms.digest(image.imdecode(data, image.IMREAD_COLOR)) == \
        EXPECTED[f"{name}:cv_color"]
    assert wx.forms.digest(image.imdecode(data, image.IMREAD_UNCHANGED)) == \
        EXPECTED[f"{name}:cv_unchanged"]


def test_fixtures_cover_every_form():
    assert len(IMAGES) == 5 + 26
    assert sum(n.endswith(".jpg") for n in IMAGES) == 3 + 2
    assert sum("animated" in n for n in IMAGES) == 2
    assert sum("alph" in n or "alpha" in n for n in IMAGES) == 5


def test_port_crop_by_word_gives_jax_output(tmp_path):
    crop_by_word.main([str(WEBP), "--out_dir", str(tmp_path), "--nproc", "1"])
    names = sorted(os.listdir(tmp_path / "imgs"))
    assert names == list(EXPECTED["jax:names"]) and len(names) == 12
    assert (tmp_path / "label.txt").read_bytes() == EXPECTED["jax:label"].tobytes()
    for name in names:
        got = image.imdecode((tmp_path / "imgs" / name).read_bytes(), image.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, EXPECTED[f"jax:crop:{name}"], err_msg=name)


def test_create_lmdb_keeps_every_webp_crop(tmp_path):
    crops = WEBP / "crops"
    for name in _files(crops):
        if name != "labels.txt":
            assert create_lmdb.check_image_valid((crops / name).read_bytes()), name
    kept = create_lmdb.create_dataset(str(crops), str(crops / "labels.txt"),
                                      str(tmp_path / "lmdb"))
    assert kept == len(_files(crops)) - 1


def test_raw_dataset_reads_webp_named_jpg_as_jax():
    common = dict(imgH=32, imgW=100, batch_max_length=8)
    opt, jopt = default_options(**common), jax_options(**common)
    got = dataset.RawDataset(str(WEBP / "crops"), opt)
    ref = jax_dataset.RawDataset(str(WEBP / "crops"), jopt)
    assert got.image_path_list == ref.image_path_list and len(got) == 2
    for i in range(len(got)):
        (g, gp), (r, rp) = got[i], ref[i]
        assert gp == rp
        np.testing.assert_array_equal(g, np.asarray(r.resize((100, 32), PIL.Image.BICUBIC)))
