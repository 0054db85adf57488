"""One MLP layer, GEMM + bias + activation, on Hopper (``csrc/fused_mlp.cu``).

Replaces the TPU kernel ``repro/kernels/fused_mlp.py::_kernel`` (via
``fused_mlp_pallas``): ``act(x @ w + b)`` with an fp32 accumulator, the bias
and the activation (relu, sigmoid or none) applied while the output tile is
still on chip, and the output written in ``out_dtype``, so the bf16 cast
between the layers of ``mlp_forward`` fuses into the epilogue.

What bounds it: operations on the wide layers, bytes on the thin ones.  At
M = 8192 a 1024 x 1024 layer does 17 GFLOP on 18.9 MB (about 900 operations
per byte), above the card's bf16 balance of about 295; the thin layers
(K = 100, N = 64, N = 1) are bound by bytes.

Two routes, chosen by ``route(M, K, N)`` before the launch:

- ``"wgmma"`` (K and N multiples of 8, the row strides a TMA tensor map
  takes): 128 x 256 output tiles where the grid still has about one for
  every SM (half the x traffic a flop of 128 x 128), else 128 x 128; a
  producer warp streams 64-deep K slices of x (K-major) and w (kept
  ``[K, N]`` as the model holds it, so an MN-major operand) by TMA into a
  4-stage ring of 128-byte-swizzled shared memory with full and empty
  mbarriers; two consumer warpgroups, 64 rows each, run ``wgmma
  m64n256k16`` (or ``m64n128k16``) from shared memory with one slice's
  products in flight behind the next, and ``setmaxnreg`` gives them the
  producer's registers.  TMA zero-fills the ragged M, N and K edges.
- ``"mma_sync"`` (every other shape: dlrm-small's K = 100 and N = 1
  layers): the first version, 8 warps of ``mma.sync.m16n8k16`` over
  128 x 128 tiles, K in steps of 32 through one shared buffer.

Each route counts its launches in ``fused_mlp_layer.route_launches``;
``fused_mlp_layer.launches`` is their total.  A failed build or launch of
either route raises: neither stands in for the other.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

plain = ref.fused_mlp_layer

_ACTIVATIONS = {"none": 0, "relu": 1, "sigmoid": 2}
_LAUNCHERS = {"wgmma": "fused_mlp_wgmma_fwd", "mma_sync": "fused_mlp_fwd"}
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def route(M: int, K: int, N: int) -> str:
    """The kernel that computes a layer of this shape on the card: "wgmma"
    where a TMA tensor map can describe x [M, K] and w [K, N] (row strides
    of a multiple of 16 bytes: K and N multiples of 8, K > 0), else
    "mma_sync".  M does not enter: TMA zero-fills a ragged last tile."""
    return "wgmma" if K > 0 and K % 8 == 0 and N % 8 == 0 else "mma_sync"


def fused_mlp_layer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, activation: str = "relu",
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """act(x @ w + b): x [M, K] bf16, w [K, N] bf16, b [N] bf16 or fp32 ->
    [M, N] ``out_dtype`` (fp32 or bf16).  CUDA tensors launch the kernel;
    CPU tensors run the plain version."""
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if x.ndim != 2 or w.ndim != 2 or b.ndim != 1 or x.shape[1] != w.shape[0] \
            or b.shape[0] != w.shape[1]:
        raise ValueError(f"need x [M, K], w [K, N], b [N], got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16 \
            or b.dtype not in (torch.bfloat16, torch.float32) \
            or out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"need bf16 x and w, bf16 or fp32 b and out_dtype; got {x.dtype}, "
                        f"{w.dtype}, {b.dtype}, {out_dtype}")
    if not (x.device == w.device == b.device):
        raise ValueError(f"x on {x.device}, w on {w.device}, b on {b.device}")
    if x.device.type == "cpu":
        return plain(x, w, b, activation, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("x, w and b must be contiguous")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned")
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M * N == 0:
        return out
    path = route(M, K, N)
    fn = build.function("fused_mlp", _LAUNCHERS[path], _ARGS)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K,
                 int(b.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
                 _ACTIVATIONS[activation], torch.cuda.current_stream().cuda_stream)
        fused_mlp_layer.launches += 1
        fused_mlp_layer.route_launches[path] += 1
    if err:
        raise RuntimeError(f"fused_mlp {path} kernel launch failed with CUDA error {err}")
    return out


fused_mlp_layer.launches = 0
fused_mlp_layer.route_launches = {"wgmma": 0, "mma_sync": 0}
