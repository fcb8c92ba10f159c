"""Sharding rules: which slice of every parameter and of the KV pool each
rank of a tensor- and expert-parallel group holds.

Counterpart of kafka_tpu/parallel/sharding.py.  The rules are the JAX
package's Megatron split, written as partition specs over the same axis
names (a tuple per tensor, one entry per dimension: None, "tp" or
("tp", "tq")); where JAX places a global array by spec, the port slices
rank r's block out of it:

  wq  [L, H, Hq, D]   heads over ("tp","tq")    column-parallel
  wk  [L, H, Hkv, D]  kv heads over "tp"        (replicated over tq)
  wv  [L, H, Hkv, D]  kv heads over "tp"
  wo  [L, Hq, D, H]   heads over ("tp","tq")    row-parallel: all-reduce
  wg  [L, H, F]       F over ("tp","tq")        column-parallel
  wu  [L, H, F]
  wd  [L, F, H]       F over ("tp","tq")        row-parallel: all-reduce
  embed [V, H], norms replicated
  lm_head [H, V]      V over ("tp","tq")        logits all-gathered
  KV pool [L, SLOTS, Hkv*D]  merged kv axis over "tp": heads are its
                      outer factor, so rank r's pool is column block
                      tp_index, whole heads
  MoE (cfg.is_moe):
  router [L, H, E]    replicated: every rank routes alike
  wg/wu [L, E, H, F]  experts over "ep", F over ("tp","tq")
  wd  [L, E, F, H]    experts over "ep", F over ("tp","tq")

The "ep" axis is used only when it divides the experts (the engine
refuses the rest); attention weights and the KV pool are replicated over
it.  Blocks over ("tp","tq") are indexed by the rank's tensor rank (its
place in its ep slice, parallel/mesh.py).

A kv axis that "tp" does not divide replicates (the JAX fallback); the
engine never builds that layout (resolve_tensor_axes).  Int8 QTensor
leaves slice their codes like the dense weight and their scales by the
same spec with size-1 dims unsharded; an int8 pool's [SLOTS, 1] scales
replicate.  A vocab that the degree does not divide gives the last ranks
fewer lm_head columns (JAX pads such a shard; the all-gather pads and
trims, parallel/tp.py).

`init_params_shard` builds rank r's shard of a random model on its own
card, so no full copy of a 70B model exists anywhere: every (tensor,
layer) — and every expert of a MoE layer — is drawn from its own seeded
generator at full width, cut, and dropped.  `init_params_shard(...,
mesh=None)` gives the whole model from the same draws, so a single-card
engine and a rank group hold the same weights.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from ..device import DeviceLike
from ..models.config import ModelConfig
from ..models.quant import QTensor, quantize_array
from .mesh import MeshConfig, RankMesh

Params = Dict[str, Any]
Spec = Tuple[Any, ...]

_TX = ("tp", "tq")


def _axes(mesh) -> Tuple[int, int]:
    """(tp, tq) of a RankMesh or a MeshConfig."""
    return mesh.tp, mesh.tq


def _ep_axis(cfg: ModelConfig, mesh) -> Optional[str]:
    """The expert shard axis, or None (replicate) when ep is 1 or does
    not divide the experts."""
    ep = getattr(mesh, "ep", 1)
    if ep > 1 and cfg.num_experts % ep == 0:
        return "ep"
    return None


def _kv_axis(cfg: ModelConfig, mesh) -> Optional[str]:
    """The kv-head shard axis, or None (replicate) when tp does not divide
    the kv heads."""
    tp, _ = _axes(mesh)
    if tp > 1 and cfg.num_kv_heads % tp == 0:
        return "tp"
    return None


def _tensor_axes(mesh):
    """The full-degree tensor axes: ("tp","tq") on grouped groups, "tp"
    otherwise."""
    _, tq = _axes(mesh)
    return _TX if tq > 1 else "tp"


def param_specs(cfg: ModelConfig, mesh) -> Params:
    """Partition specs congruent with init_params' tree (dense and MoE
    models; JAX parallel/sharding.py:66-109)."""
    kv = _kv_axis(cfg, mesh)
    tx = _tensor_axes(mesh)
    layers: Params = {
        "ln_attn": (),
        "ln_mlp": (),
        "wq": (None, None, tx, None),
        "wk": (None, None, kv, None),
        "wv": (None, None, kv, None),
        "wo": (None, tx, None, None),
    }
    if cfg.is_moe:
        ep = _ep_axis(cfg, mesh)
        layers["router"] = ()
        layers["wg"] = (None, ep, None, tx)     # [L, E, H, F]
        layers["wu"] = (None, ep, None, tx)
        layers["wd"] = (None, ep, tx, None)     # [L, E, F, H]
    else:
        layers["wg"] = (None, None, tx)
        layers["wu"] = (None, None, tx)
        layers["wd"] = (None, tx, None)
    specs: Params = {"embed": (), "final_norm": (), "layers": layers}
    if not cfg.tie_word_embeddings:
        specs["lm_head"] = (None, tx)
    return specs


def kv_pool_spec(cfg: ModelConfig, mesh) -> Spec:
    """[L, SLOTS, Hkv*D]: each rank caches its kv heads."""
    return (None, None, _kv_axis(cfg, mesh))


def _block(mesh: RankMesh, ax) -> Tuple[int, int]:
    """(block index, block count) of a spec entry for this rank."""
    if ax == "tp":
        return mesh.tp_index, mesh.tp
    if ax == _TX:
        return mesh.tensor_rank, mesh.tensor_size
    if ax == "ep":
        return mesh.ep_index, mesh.ep
    raise ValueError(f"unknown mesh axis {ax!r}")


def _slice(x: torch.Tensor, spec: Spec, mesh: RankMesh,
           ragged: bool = False) -> torch.Tensor:
    """This rank's block of x by spec, in storage of its own (a view would
    keep the whole tensor alive)."""
    whole = x
    for dim, ax in enumerate(spec):
        if ax is None or x.shape[dim] == 1:
            continue
        idx, n = _block(mesh, ax)
        size = x.shape[dim]
        if size % n and not ragged:
            raise ValueError(
                f"dimension {dim} of size {size} does not split {n} ways")
        width = -(-size // n)
        lo = min(idx * width, size)
        x = x.narrow(dim, lo, min(size, lo + width) - lo)
    if x is whole:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def shard_params(params: Params, cfg: ModelConfig,
                 mesh: RankMesh) -> Params:
    """Rank `mesh.rank`'s slice of a full parameter tree (torch tensors or
    QTensors; numpy leaves are converted)."""
    specs = param_specs(cfg, mesh)

    def place(x, spec, ragged=False):
        if isinstance(x, QTensor):
            return QTensor(q=_slice(x.q, spec, mesh, ragged),
                           s=_slice(x.s, spec, mesh, ragged))
        return _slice(torch.as_tensor(x), spec, mesh, ragged)

    out: Params = {k: place(v, specs[k], ragged=(k == "lm_head"))
                   for k, v in params.items() if k != "layers"}
    out["layers"] = {k: place(v, specs["layers"][k])
                     for k, v in params["layers"].items()}
    return out


def shard_kv_pool(k_pool: Any, v_pool: Any, cfg: ModelConfig,
                  mesh: RankMesh) -> Tuple[Any, Any]:
    """Rank r's column block of full [L, SLOTS, Hkv*D] pools (an int8
    pool's [L, SLOTS, 1] scales replicate)."""
    spec = kv_pool_spec(cfg, mesh)

    def place(pool):
        if isinstance(pool, QTensor):
            return QTensor(q=_slice(pool.q, spec, mesh), s=pool.s)
        return _slice(pool, spec, mesh)

    return place(k_pool), place(v_pool)


def local_heads(cfg: ModelConfig, mesh: RankMesh) -> Tuple[int, int]:
    """(q heads, kv heads) one rank holds."""
    hkv = cfg.num_kv_heads
    if _kv_axis(cfg, mesh) is not None:
        hkv //= mesh.tp
    return cfg.num_heads // mesh.tensor_size, hkv


def local_experts(cfg: ModelConfig, mesh: RankMesh) -> slice:
    """The experts one rank holds: block ep_index of ep (all of them on
    a dense model or when ep does not divide them)."""
    if _ep_axis(cfg, mesh) is None:
        return slice(0, cfg.num_experts)
    n = cfg.num_experts // mesh.ep
    return slice(mesh.ep_index * n, (mesh.ep_index + 1) * n)


def local_kv_map(cfg: ModelConfig, mesh: RankMesh) -> Optional[list]:
    """The local kv head of each local q head, or None where it is the
    contiguous GQA map (q head i reads kv head i // (Hq_l / Hkv_l)) that
    the plain attention and the kernels assume: always when tq == 1 or
    one kv head is local.  Otherwise (a grouped split with several kv
    heads per shard, or replicated kv) the plain attention gathers by it;
    kernel_mesh_ok keeps the kernels off such layouts."""
    hq_l, hkv_l = local_heads(cfg, mesh)
    g = cfg.num_heads // cfg.num_kv_heads
    kv0 = mesh.tp_index * hkv_l if _kv_axis(cfg, mesh) is not None else 0
    want = [(mesh.tensor_rank * hq_l + i) // g - kv0 for i in range(hq_l)]
    if hq_l % hkv_l == 0 and want == [i // (hq_l // hkv_l)
                                      for i in range(hq_l)]:
        return None
    return want


# ---------------------------------------------------------------------------
# random weights, one shard per rank
# ---------------------------------------------------------------------------

# init_params' draw order and fan-ins: (name, per-layer shape, fan_in,
# per-expert: the shape is one expert's of a MoE layer's stack)
def _layer_shapes(cfg: ModelConfig):
    h, f, d = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    attn = (("wq", (h, hq, d), h, False), ("wk", (h, hkv, d), h, False),
            ("wv", (h, hkv, d), h, False), ("wo", (hq, d, h), hq * d, False))
    moe = cfg.is_moe
    mlp = (("wg", (h, f), h, moe), ("wu", (h, f), h, moe),
           ("wd", (f, h), f, moe))
    router = (("router", (h, cfg.num_experts), h, False),) if moe else ()
    return attn + mlp + router


# per-layer (per-expert) contraction axes: models/quant.py _CONTRACT and
# _CONTRACT_MOE without the layer and expert axes; the router stays dense
_CONTRACT_LAYER = {"wq": (0,), "wk": (0,), "wv": (0,), "wo": (0, 1),
                   "wg": (0,), "wu": (0,), "wd": (0,)}


def _draw_seed(seed: int, name: str, layer: int,
               expert: Optional[int] = None) -> int:
    key = f"{seed}/{name}/{layer}" + (
        f"/{expert}" if expert is not None else "")
    digest = hashlib.sha256(key.encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def init_params_shard(cfg: ModelConfig, seed: int,
                      mesh: Optional[RankMesh] = None,
                      device: DeviceLike = None, dtype=None,
                      quantize: str = "") -> Params:
    """Random weights (normal * fan_in^-0.5, as init_params) for rank
    `mesh.rank` of a rank group, drawn on `device` one (tensor, layer) at
    a time — one (tensor, layer, expert) for a MoE layer's experts —
    from a generator seeded by those names and sliced there, so a rank
    never holds more than one full layer tensor or expert; only the
    experts of the rank's ep slice are drawn.  mesh=None returns every
    tensor whole: the same weights a rank group shares out, so a
    single-card engine and a rank group hold the same model.
    quantize="int8" quantizes each full tensor (each expert) before it
    is cut (per-output-channel scales over the whole contraction, as
    quantize_params then shard_params would give); the router stays
    dense.  An int8 mixtral-8x7b is thus built on one card without its
    bf16 form (~93 GB) ever existing."""
    dtype = dtype or cfg.activation_dtype
    dev = torch.device(device) if device is not None else None
    specs = param_specs(cfg, mesh) if mesh is not None else None
    L = cfg.num_layers
    experts = (local_experts(cfg, mesh) if mesh is not None
               else slice(0, cfg.num_experts))

    def draw(name: str, layer: int, shape: Sequence[int], fan_in: int,
             expert: Optional[int] = None):
        gen = torch.Generator(device=dev or "cpu")
        gen.manual_seed(_draw_seed(seed, name, layer, expert))
        w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                        device=dev)
        return (w * fan_in ** -0.5).to(dtype)

    def cut(x, spec, ragged=False):
        if specs is None:
            return x
        if isinstance(x, QTensor):
            return QTensor(q=_slice(x.q, spec, mesh, ragged),
                           s=_slice(x.s, spec, mesh, ragged))
        return _slice(x, spec, mesh, ragged)

    layers: Params = {
        "ln_attn": torch.ones((L, cfg.hidden_size), dtype=dtype, device=dev),
        "ln_mlp": torch.ones((L, cfg.hidden_size), dtype=dtype, device=dev),
    }
    for name, shape, fan_in, per_expert in _layer_shapes(cfg):
        # the spec of one unit: a layer's tensor, or one expert of it
        lead = 2 if per_expert else 1
        spec = specs["layers"][name][lead:] if specs is not None else None
        units = ([(layer, e) for layer in range(L)
                  for e in range(experts.start, experts.stop)]
                 if per_expert else [(layer, None) for layer in range(L)])
        q8 = quantize == "int8" and name in _CONTRACT_LAYER
        stacked = None
        for layer, e in units:
            w = draw(name, layer, shape, fan_in, e)
            if q8:
                w = quantize_array(w, _CONTRACT_LAYER[name])
            w = cut(w, spec)
            leaves = (w.q, w.s) if q8 else (w,)
            if stacked is None:  # the stack, filled in place
                dims = (L, experts.stop - experts.start) if per_expert \
                    else (L,)
                stacked = [torch.empty(dims + tuple(a.shape), dtype=a.dtype,
                                       device=a.device) for a in leaves]
            at = (layer, e - experts.start) if per_expert else layer
            for out, a in zip(stacked, leaves):
                out[at].copy_(a)
            del w, leaves
        layers[name] = (QTensor(q=stacked[0], s=stacked[1]) if q8
                        else stacked[0])
    embed = draw("embed", 0, (cfg.vocab_size, cfg.hidden_size),
                 cfg.hidden_size)
    params: Params = {
        "embed": (quantize_array(embed, (1,)) if quantize == "int8"
                  else embed),
        "final_norm": torch.ones((cfg.hidden_size,), dtype=dtype, device=dev),
        "layers": layers,
    }
    if not cfg.tie_word_embeddings:
        head = draw("lm_head", 0, (cfg.hidden_size, cfg.vocab_size),
                    cfg.hidden_size)
        if quantize == "int8":
            head = quantize_array(head, (0,))
        params["lm_head"] = cut(head, specs["lm_head"] if specs else None,
                                ragged=True)
    elif quantize not in ("", "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    return params
