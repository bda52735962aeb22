"""``tests/fixtures/torch_forms/`` is what ``scripts/make_torch_forms_fixtures.py``
writes, and the port reproduces it: every file's Pillow and cv2 views (the
digests in ``expected.npz``) and the JAX ``crop_by_word`` run on its scene
tree.  ``chip_smoke.py`` runs the same checks on the card's machine."""

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

from mrn_tpu_torch.data import image
from mrn_tpu_torch.tools import crop_by_word

ROOT = Path(__file__).resolve().parents[1]
FORMS = ROOT / "tests" / "fixtures" / "torch_forms"
_spec = importlib.util.spec_from_file_location(
    "make_torch_forms_fixtures", ROOT / "scripts" / "make_torch_forms_fixtures.py")
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)
EXPECTED = np.load(FORMS / "expected.npz")


def _files(root):
    return sorted(str(p.relative_to(root)) for p in Path(root).rglob("*") if p.is_file())


def test_committed_fixtures_are_what_the_script_writes(tmp_path):
    fx.build(str(tmp_path / "forms"))
    assert _files(tmp_path / "forms") == _files(FORMS)
    for name in _files(FORMS):
        if name != "expected.npz":
            assert (tmp_path / "forms" / name).read_bytes() == (FORMS / name).read_bytes(), name
    fresh = np.load(tmp_path / "forms" / "expected.npz")
    assert sorted(fresh.files) == sorted(EXPECTED.files)
    for key in EXPECTED.files:
        np.testing.assert_array_equal(fresh[key], EXPECTED[key], err_msg=key)
    total = sum((FORMS / n).stat().st_size for n in _files(FORMS))
    assert total < 600 * 1024


IMAGES = [n for n in _files(FORMS) if n.startswith(("imgs/", "crops/")) and
          not n.endswith(".txt")]


@pytest.mark.parametrize("name", IMAGES)
def test_port_reproduces_each_fixture(name):
    data = (FORMS / name).read_bytes()
    assert fx.digest(image.decode(data)) == EXPECTED[f"{name}:pil"]
    if f"{name}:cv_color" not in EXPECTED.files:
        with pytest.raises(image.UnsupportedImage, match="BMP under cv2's imread"):
            image.imdecode(data)
        return
    assert fx.digest(image.imdecode(data, image.IMREAD_COLOR)) == EXPECTED[f"{name}:cv_color"]
    assert fx.digest(image.imdecode(data, image.IMREAD_UNCHANGED)) == \
        EXPECTED[f"{name}:cv_unchanged"]


def test_fixtures_cover_every_form():
    assert len(IMAGES) == 9 + 19
    assert sum(n.endswith(".gif") for n in IMAGES) == 2
    assert sum(n.endswith(".bmp") for n in IMAGES) == 6


def test_port_crop_by_word_gives_jax_output(tmp_path):
    crop_by_word.main([str(FORMS), "--out_dir", str(tmp_path), "--nproc", "1"])
    names = sorted(os.listdir(tmp_path / "imgs"))
    assert names == list(EXPECTED["jax:names"])
    assert (tmp_path / "label.txt").read_bytes() == EXPECTED["jax:label"].tobytes()
    for name in names:
        got = image.imdecode((tmp_path / "imgs" / name).read_bytes(), image.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got, EXPECTED[f"jax:crop:{name}"], err_msg=name)
