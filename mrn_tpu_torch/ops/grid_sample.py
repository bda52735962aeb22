"""The TPS warp: a hand-written CUDA kernel plus its plain PyTorch version
(mirrors ``mrn_tpu/ops/grid_sample.py``).

Bilinear sampling with torch ``grid_sample`` semantics, ``padding_mode=
"border"`` and ``align_corners=True``, on NHWC images: ``image [B, H, W,
C]`` in the working dtype (float32 or bfloat16), ``grid [B, Ho, Wo, 2]``
holding (x, y) in [-1, 1], always float32, output ``[B, Ho, Wo, C]`` in the
image's dtype.  Both versions compute what the Pallas kernel
(``grid_sample_pallas``) computes, in float32: the JAX package's
``_unnormalize`` and ``_corners``, the horizontal interpolation, then the
vertical one, rounded to the image's dtype once.

``grid_sample(image, grid)`` launches the CUDA kernel (``csrc/
grid_sample.cu``) for CUDA tensors and runs the plain version
(``grid_sample_reference``) for CPU tensors; there is no fallback between
the two.  Both go through the PyTorch custom op
``torch.ops.mrn_tpu_torch.grid_sample`` (registered when this module is
imported, with a fake implementation for shapes), so ``torch.export``
traces the warp as one node.  The kernel is forward only, as in JAX:
eval-mode TPS warps through it.

``grid_sample_train(image, grid)`` is the train-mode TPS warp:
differentiable in the image and the grid, plain PyTorch on either device,
never counted.  It is the port of the JAX package's XLA training warp (the
four-tap gather of ``grid_sample_gather``), not the kernel's plain version.
No kernel is written for it because JAX has none: the Pallas warp defines
no VJP, and JAX's train-mode TPS differentiates XLA ops.
"""

from __future__ import annotations

import ctypes
import functools

import torch

__all__ = ["grid_sample", "grid_sample_reference", "grid_sample_train", "launches"]

# CUDA launches (the plain version never counts).
launches = 0


def _check(image: torch.Tensor, grid: torch.Tensor) -> None:
    if image.ndim != 4 or grid.ndim != 4 or grid.shape[0] != image.shape[0] \
            or grid.shape[3] != 2:
        raise ValueError(f"grid_sample: image [B, H, W, C] and grid [B, Ho, Wo, 2], got "
                         f"{tuple(image.shape)} and {tuple(grid.shape)}")
    if grid.dtype != torch.float32:
        # bf16 coordinates would shift the taps by up to half a pixel at W = 256
        raise TypeError(f"grid_sample: the grid must be float32, not {grid.dtype}")
    if image.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grid_sample takes float32/bfloat16 images, not {image.dtype}")
    if grid.device != image.device:
        raise ValueError("grid_sample: image and grid on different devices")


# ------------------------------------------------------------ plain version
def _unnormalize(coord: torch.Tensor, size: int) -> torch.Tensor:
    """align_corners=True mapping from [-1, 1] to pixels, then the border
    clamp."""
    return torch.clamp((coord + 1.0) * 0.5 * (size - 1), 0.0, float(size - 1))


def _corners(ix: torch.Tensor, size: int):
    x0 = torch.floor(ix)
    fx = ix - x0
    x0i = x0.to(torch.int64).clamp(0, size - 1)
    return x0i, (x0i + 1).clamp(max=size - 1), fx


def _four_taps(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """``grid_sample_gather``'s four taps with the Pallas kernel's rounding
    (float32 throughout, one rounding to the image's dtype).  Autograd
    reaches the image through the gathers and the grid through ``fx`` /
    ``fy`` (the floor and the integer taps carry no gradient; the border
    clamp passes it inside the range)."""
    _check(image, grid)
    b, h, w, c = image.shape
    _, ho, wo, _ = grid.shape
    x0, x1, fx = _corners(_unnormalize(grid[..., 0], w), w)
    y0, y1, fy = _corners(_unnormalize(grid[..., 1], h), h)
    flat = image.reshape(b, h * w, c)

    def take(yi, xi):
        idx = (yi * w + xi).reshape(b, ho * wo, 1).expand(-1, -1, c)
        return torch.gather(flat, 1, idx).reshape(b, ho, wo, c).float()

    fx, fy = fx[..., None], fy[..., None]
    top = take(y0, x0) * (1.0 - fx) + take(y0, x1) * fx
    bot = take(y1, x0) * (1.0 - fx) + take(y1, x1) * fx
    return (top * (1.0 - fy) + bot * fy).to(image.dtype)


def grid_sample_reference(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel (its arithmetic, for tests and checks)."""
    return _four_taps(image, grid)


def grid_sample_train(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The train-mode warp, differentiable in ``image`` and ``grid``: the
    four taps in plain PyTorch on any device (on the card ``gather``'s
    backward is an atomic ``scatter_add``, so image gradients are not
    bitwise repeatable)."""
    return _four_taps(image, grid)


# --------------------------------------------------------------- CUDA kernel
@functools.lru_cache(maxsize=None)
def _lib():
    from mrn_tpu_torch.ops import _build

    lib = _build.load("grid_sample")
    p, i = ctypes.c_void_p, ctypes.c_int
    # dtype; image, grid, out; B H W C Ho Wo; stream
    lib.grid_sample_forward.argtypes = [i] + [p] * 3 + [i] * 6 + [p]
    lib.grid_sample_forward.restype = i
    lib.grid_sample_error_string.argtypes = [i]
    lib.grid_sample_error_string.restype = ctypes.c_char_p
    return lib


def _grid_sample_cuda(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    global launches
    if not (image.is_contiguous() and grid.is_contiguous()):
        raise ValueError("grid_sample kernel takes contiguous tensors")
    b, h, w, c = image.shape
    _, ho, wo, _ = grid.shape
    out = torch.empty((b, ho, wo, c), dtype=image.dtype, device=image.device)
    lib = _lib()
    with torch.cuda.device(image.device):
        rc = lib.grid_sample_forward(
            1 if image.dtype == torch.bfloat16 else 0, image.data_ptr(), grid.data_ptr(),
            out.data_ptr(), b, h, w, c, ho, wo,
            torch.cuda.current_stream(image.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("grid_sample kernel launch failed: "
                           + lib.grid_sample_error_string(rc).decode())
    launches += 1
    return out


@torch.library.custom_op("mrn_tpu_torch::grid_sample", mutates_args=(), device_types="cpu")
def _grid_sample_op(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The warp; CPU: the plain version."""
    return grid_sample_reference(image, grid)


_grid_sample_op.register_kernel("cuda")(_grid_sample_cuda)


@_grid_sample_op.register_fake
def _grid_sample_op_fake(image, grid):
    return image.new_empty((image.shape[0], grid.shape[1], grid.shape[2], image.shape[3]))


def grid_sample(image: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """The warp: the plain version on the CPU, the CUDA kernel on the card
    (or raises)."""
    if image.device.type not in ("cpu", "cuda"):
        raise ValueError(f"grid_sample: unsupported device {image.device}")
    _check(image, grid)
    return _grid_sample_op(image, grid)
