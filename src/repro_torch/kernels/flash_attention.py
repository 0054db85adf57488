"""Flash attention forward on Hopper (``csrc/flash_attention.cu``).

Replaces the TPU kernel ``repro/kernels/flash_attention.py::_kernel`` (via
``flash_attention_pallas`` and the jitted wrapper
``repro/kernels/ops.py::flash_attention``): ``o = softmax(mask(softcap(scale
· q kᵀ))) v`` with an online softmax, GQA, gemma2's logit soft-cap, causal
and sliding-window masks, and right-aligned query positions (query i sits at
key position ``Lk - Lq + i``).  The LM prefill reaches it once a layer
through ``models.attention.attention(impl="pallas")``.

What bounds it: operations.  At internlm2-1.8b's prefill (B = 4, H = 16,
L = 4096, D = 128, causal) it does 2.7e11 operations on 134 MB of q, k, v
and o, about 2,000 operations a byte against the card's bf16 balance of
about 295.

Design (Hopper, warp-specialised): one block of three warpgroups per (128
queries, head, batch), in place of the TPU's sequential key-block grid axis
and its VMEM scratch.  The producer warpgroup lowers its registers
(``setmaxnreg``) and one of its threads loads the Q tile once and the
visible K and V tiles of 128 keys by TMA (3-D tensor maps over ``[B·H, Lq,
D]`` and ``[B·Hkv, Lk, D]``, 128-byte swizzle, zero fill past ``Lq`` and
``Lk``) into two-stage rings with full and empty mbarriers; head h reads KV
row ``b·Hkv + h // (H / Hkv)``, so no repeated K/V copy is made.  The two
consumer warpgroups own 64 query rows each and keep their running max, sum
and fp32 output in registers: ``S = Q Kᵀ`` is ``wgmma m64n128k16`` with both
operands in shared memory, the softmax runs on the accumulator layout (in
log2 units, the scale folded into one FMA before ``ex2.approx``; the
soft-cap and the masks are template paths, so a tile pays for neither where
it has none), and ``O += bf16(P) V`` is ``wgmma`` with P's fragments in
registers and V, stored ``[keys, D]``, as an MN-major operand.  Each chain
of ``wgmma`` is one asm statement: written as separate statements, the
compiler copied accumulators between two in-flight ``wgmma`` and ptxas
serialized them.  Each consumer issues tile i's score
product and tile i-1's PV product in one turn, ordered against the other
consumer's turn by named barriers, and runs tile i's softmax while the
other's products run.  The block walks only the key tiles its queries can
see (causal, window and ``Lk``), the TPU kernel's ``pl.when(needed)`` skip
that makes gemma2's local layers cost O(L·W).  The key tile is 128, as the
TPU kernel's ``bk``: ``p`` is rounded to bf16 against the running max, so
where the tiles split the keys fixes the bits, and the plain version
(``ref.flash_attention``, ``bk=128``) follows the same split.  The
soft-cap keeps the accurate ``tanhf``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (64, 128)
_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
         ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
         ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    softcap: float = 0.0, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """q [B, H, Lq, D], k and v [B, Hkv, Lk, D] (H % Hkv == 0) -> [B, H, Lq,
    D] in q's dtype.  ``window`` 0 is global attention, ``softcap`` 0 none,
    ``scale`` None ``D ** -0.5``.  CUDA tensors (bf16, contiguous, D 64 or
    128) launch the kernel; CPU tensors run the plain version."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[3] != k.shape[3] or k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError(f"need q [B, H, Lq, D] and k, v [B, Hkv, Lk, D] with H % Hkv == 0, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal, softcap, window, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"need bf16 q, k and v, got {q.dtype}, {k.dtype}, {v.dtype}")
    B, H, Lq, D = q.shape
    Hkv, Lk = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}: the kernel takes {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else D ** -0.5
    fn = build.function("flash_attention", "flash_attention_fwd", _ARGS)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, Hkv, Lq, Lk, D,
                 float(np.float32(scale)), int(causal), float(np.float32(softcap)), int(window),
                 torch.cuda.current_stream().cuda_stream)
        flash_attention.launches += 1
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA error {err}")
    return out


flash_attention.launches = 0
