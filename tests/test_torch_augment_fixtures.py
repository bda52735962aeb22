"""The committed augmentation fixtures (``tests/fixtures/torch_augment/``,
written by ``scripts/make_torch_augment_fixtures.py``) on the CPU: the files
still give Pillow's, OpenCV's and the JAX package's arrays, and the port
(``mrn_tpu_torch.data.augment_fixtures.check``, which ``chip_smoke.py``
runs on the card's machine) gives them too, bit for bit or within the
bounds that module states."""

import importlib.util
import os

import cv2
import numpy as np
import PIL.Image
import PIL.ImageEnhance
import PIL.ImageFilter
import pytest

from mrn_tpu_torch.data import augment_fixtures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FOLDER = os.path.join(ROOT, "tests", "fixtures", "torch_augment")


@pytest.fixture(scope="module")
def fixtures():
    return augment_fixtures.load(FOLDER)


@pytest.fixture(scope="module")
def script():
    path = os.path.join(ROOT, "scripts", "make_torch_augment_fixtures.py")
    spec = importlib.util.spec_from_file_location("make_torch_augment_fixtures", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _library_op(op, args, img):
    """Pillow's or OpenCV's output for fixture op ``op`` (the script's
    calls, from the stored arguments)."""
    pil = PIL.Image.fromarray(img)
    if op == "blur":
        return np.asarray(pil.filter(PIL.ImageFilter.GaussianBlur(float(args[0]))))
    if op == "rotate":
        return np.asarray(pil.rotate(float(args[0]), PIL.Image.BICUBIC, expand=True))
    if op in ("brightness", "contrast", "color"):
        return np.asarray(getattr(PIL.ImageEnhance, op.capitalize())(pil).enhance(float(args[0])))
    if op == "hue":
        h, s, v = pil.convert("RGB").convert("HSV").split()
        h = h.point(lambda px: (px + int(float(args[0]) * 255)) % 256)
        out = PIL.Image.merge("HSV", (h, s, v)).convert("RGB")
        out.putalpha(pil.getchannel("A"))
        return np.asarray(out)
    interp = int(op[-1]) if op[-1].isdigit() else None
    if op.startswith("affine"):
        return cv2.warpAffine(img, args[:6].reshape(2, 3), (int(args[6]), int(args[7])),
                              flags=interp, borderMode=cv2.BORDER_REPLICATE)
    if op.startswith("perspective"):
        return cv2.warpPerspective(img, args[:9].reshape(3, 3), (int(args[9]), int(args[10])),
                                   flags=interp, borderMode=cv2.BORDER_REPLICATE)
    if op.startswith("boxpoints"):
        rect = cv2.minAreaRect(args.reshape(4, 2).astype(np.float32))
        return cv2.boxPoints(rect).astype(np.int64)
    if op.startswith("resize_up"):
        return cv2.resize(img, (int(args[0]), int(args[1])), interpolation=interp)
    if op.startswith("resize_down"):
        up = cv2.resize(img, (int(args[0]), int(args[1])), interpolation=interp)
        return cv2.resize(cv2.pyrDown(cv2.pyrDown(up)), (int(args[2]), int(args[3])),
                          interpolation=interp)
    if op == "pyrdown":
        return cv2.pyrDown(img)
    degree, angle = int(args[0]), float(args[1])
    kernel = np.zeros((degree, degree))
    kernel[degree // 2, :] = 1
    kernel = cv2.warpAffine(kernel, cv2.getRotationMatrix2D((degree // 2, degree // 2), angle, 1),
                            (degree, degree))
    return kernel if op == "kernel" else cv2.filter2D(img, -1, kernel / degree)


def test_fixture_files_still_give_the_libraries_arrays(fixtures, script):
    names, crops, expected = fixtures
    assert sum(os.path.getsize(os.path.join(FOLDER, f)) for f in os.listdir(FOLDER)) <= 400 << 10
    ops = [k for k in expected if k.count(":") == 2]
    assert len(names) == len(script.CROP_SIZES) and len(ops) > 60
    for key in ops:
        name, op, _ = key.split(":")
        want = _library_op(op, expected[key + ":args"], crops[name])
        assert want.dtype == expected[key].dtype and np.array_equal(want, expected[key]), key
    chains = script.chains([PIL.Image.fromarray(crops[n]) for n in names])
    for chain, outs in chains.items():
        for name, arr in zip(names, outs):
            assert np.array_equal(arr, expected[f"{name}:{chain}"]), f"{name}:{chain}"


def test_port_gives_the_fixture_arrays():
    result = augment_fixtures.check(FOLDER)
    assert result["failures"] == []
    assert result["arrays"] == result["bitwise"] + len(result["bounded"])
    assert result["bitwise"] >= result["arrays"] - 6, result["bounded"]
