"""K5: the fused decode MLP block — CUDA kernel wrapper and its plain
version.

Replaces the Pallas kernel `fused_mlp_block`
(kafka_tpu/ops/pallas/fused_mlp.py:153, body `_kernel` at :84):

    out = h + W_d(silu(nx W_g) * (nx W_u)),   nx = rmsnorm(h) * ln

with bf16 or int8 weights (per-output-channel f32 scales applied to each
projection's f32 output).  As in the JAX package it is not wired into
serving: the port's decode MLP stays the torch formulation
(models/llama.py) until a chip run shows this kernel beating it.  The
kernel is csrc/fused_mlp.cu (design and bound in its header: bytes-bound,
the three weight matrices read once, products on the tensor cores).  A
call makes three launches: the norm, the gate/up pass and the down pass,
whose contraction over F the kernel splits up to 8 ways (one thread block
cluster per column tile); its only scratch is nx [B, H] and the gate/up
product [B, F], both bf16.
`fused_mlp_block` launches it for CUDA tensors and runs
`fused_mlp_block_plain` — the same function in plain PyTorch, with the
JAX kernel's rounding points — for CPU tensors only; it never falls back.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from . import build
from .common import stream_ptr

# rows a launch takes (decode batches); the kernel reads the weights once
# for any of them
MAX_ROWS = 64
# H and F must be multiples of this: the kernel's stages are 128 rows of
# int8 (64 of bf16), its column tiles 32 (gate/up) and 64 (down) wide
TILE = 128


def fused_mlp_block_plain(
    h: torch.Tensor,              # [B, H] residual stream
    ln_w: torch.Tensor,           # [H] rmsnorm weight
    wg: torch.Tensor,             # [H, F] (activation dtype or int8)
    wu: torch.Tensor,             # [H, F]
    wd: torch.Tensor,             # [F, H]
    sg: Optional[torch.Tensor] = None,   # [1, F] f32 scales (int8 only)
    su: Optional[torch.Tensor] = None,   # [1, F]
    sd: Optional[torch.Tensor] = None,   # [1, H]
    *,
    eps: float,
) -> torch.Tensor:
    """h + SwiGLU(rmsnorm(h) * ln_w) in h.dtype, rounded where the JAX
    kernel rounds: the norm in f32; each projection accumulated in f32
    (exact products of the operands), scaled, then cast; the sigmoid in
    f32; the residual add in h.dtype."""
    dt = h.dtype
    x32 = h.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    nx = (x32 * torch.rsqrt(var + eps) * ln_w.float()).to(dt)

    def mm(x, w):
        return x.float() @ w.to(dt).float()

    g, u = mm(nx, wg), mm(nx, wu)
    if sg is not None:
        g, u = g * sg, u * su
    g, u = g.to(dt), u.to(dt)
    g32 = g.float()
    p = (g32 * torch.sigmoid(g32)).to(dt) * u
    acc = mm(p, wd)
    if sd is not None:
        acc = acc * sd
    return h + acc.to(dt)


def check_args(h, ln_w, wg, wu, wd, scales) -> Tuple[int, int, int, bool]:
    """What the kernel takes, on tensors of any one device: raises
    ValueError naming the limit; returns (B, H, F, int8)."""
    name = "fused_mlp_block"
    tensors = [h, ln_w, wg, wu, wd] + [s for s in scales if s is not None]
    for t in tensors:
        if t.device != h.device:
            raise ValueError(f"{name}: all tensors must be on {h.device}, "
                             f"got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if h.dtype != torch.bfloat16 or ln_w.dtype != torch.bfloat16:
        raise ValueError(f"{name}: h and ln_w must be bfloat16, got "
                         f"{h.dtype}, {ln_w.dtype}")
    if h.dim() != 2:
        raise ValueError(f"{name}: h must be [B, H], got {tuple(h.shape)}")
    B, H = h.shape
    F = wg.shape[-1]
    if ln_w.shape != (H,) or wg.shape != (H, F) or wu.shape != (H, F) \
            or wd.shape != (F, H):
        raise ValueError(
            f"{name}: want ln [H], wg/wu [H, F], wd [F, H] with H={H}; got "
            f"{tuple(ln_w.shape)}, {tuple(wg.shape)}, {tuple(wu.shape)}, "
            f"{tuple(wd.shape)}")
    if not 1 <= B <= MAX_ROWS:
        raise ValueError(f"{name}: the kernel takes 1..{MAX_ROWS} rows "
                         f"(B <= {MAX_ROWS}); got B={B}")
    if H % TILE or F % TILE:
        raise ValueError(f"{name}: the kernel takes H and F multiples of "
                         f"{TILE}; got H={H} F={F}")
    if any(w.data_ptr() % 16 for w in (wg, wu, wd)):
        raise ValueError(f"{name}: the kernel copies weight rows in "
                         "16-byte pieces; the weights must be 16-byte "
                         "aligned")
    int8 = wg.dtype == torch.int8
    want = torch.int8 if int8 else torch.bfloat16
    if any(w.dtype != want for w in (wg, wu, wd)):
        raise ValueError(f"{name}: weights must be all bfloat16 or all "
                         f"int8, got {wg.dtype}, {wu.dtype}, {wd.dtype}")
    given = [s is not None for s in scales]
    if (int8 and not all(given)) or (not int8 and any(given)):
        raise ValueError(f"{name}: int8 weights take all three scales, "
                         "bf16 weights none")
    if int8:
        for s, n in zip(scales, (F, F, H)):
            if s.dtype != torch.float32 or s.numel() != n:
                raise ValueError(f"{name}: scales must be float32 of "
                                 f"{F}, {F}, {H} elements")
    return B, H, F, int8


def fused_mlp_block(
    h: torch.Tensor,
    ln_w: torch.Tensor,
    wg: torch.Tensor,
    wu: torch.Tensor,
    wd: torch.Tensor,
    sg: Optional[torch.Tensor] = None,
    su: Optional[torch.Tensor] = None,
    sd: Optional[torch.Tensor] = None,
    *,
    eps: float,
) -> torch.Tensor:
    """h + SwiGLU_mlp(rmsnorm(h) * ln_w).  Returns [B, H] in h.dtype.

    CPU tensors: the plain version.  CUDA tensors: the csrc kernel (bf16
    h and ln_w, bf16 or int8 weights, f32 scales for int8, contiguous,
    16-byte aligned weights, B <= 64, H and F multiples of 128) or an
    error.
    """
    if h.device.type == "cpu":
        return fused_mlp_block_plain(h, ln_w, wg, wu, wd, sg, su, sd,
                                     eps=eps)
    if h.device.type != "cuda":
        raise ValueError(f"fused_mlp_block: h must be a CUDA or CPU tensor, "
                         f"got {h.device}")
    B, H, F, int8 = check_args(h, ln_w, wg, wu, wd, (sg, su, sd))
    dev = h.device
    nx = torch.empty_like(h)
    p = torch.empty((B, F), dtype=h.dtype, device=dev)
    out = torch.empty_like(h)
    lib = build.load("fused_mlp")
    rc = lib.kafka_fused_mlp(
        h.data_ptr(), ln_w.data_ptr(), wg.data_ptr(), wu.data_ptr(),
        wd.data_ptr(), sg.data_ptr() if int8 else None,
        su.data_ptr() if int8 else None, sd.data_ptr() if int8 else None,
        nx.data_ptr(), p.data_ptr(), out.data_ptr(), B, H, F, int(int8),
        float(eps), stream_ptr(dev),
    )
    if rc != 0:
        raise RuntimeError(f"fused MLP kernel launch failed: CUDA error {rc}")
    fused_mlp_block.launches += 1
    return out


fused_mlp_block.launches = 0


def fused_mlp_args(layers: Any, l: int) -> tuple:
    """Layer l's (ln_w, wg, wu, wd, sg, su, sd) from a layer-stacked
    parameter tree (models/llama.py); int8 QTensor weights give their
    codes and their [1, F] / [1, H] scale rows, bf16 weights None."""
    ws, ss = [], []
    for name in ("wg", "wu", "wd"):
        w = layers[name]
        if isinstance(w, tuple):  # QTensor: codes [L, ...], scales [L, 1, N]
            ws.append(w.q[l])
            ss.append(w.s[l])
        else:
            ws.append(w[l])
            ss.append(None)
    return (layers["ln_mlp"][l], *ws, *ss)
