"""Logical-axis sharding rules of the LM substrate, and the placement of a
tree of tensors on a mesh (the counterpart of the JAX package's
``sharding.py``, MaxText-style).

Every parameter leaf is given a tuple of *logical* axis names from its
path and shape (``logical_axes_for``); ``LOGICAL_RULES`` maps logical
names to mesh axes, and ``resolve`` turns them into a ``PartitionSpec``
with the JAX package's entries: divisibility-aware (a logical axis binds
to a mesh axis only where the dimension divides by the axis size) and
first binding wins.  The same rules drive (data, model) and (pod, data,
model) meshes: the batch over ('pod', 'data'), parameters 2-D sharded
(FSDP over 'data' x TP over 'model') and replicated across pods.

The JAX package stacks layers on a leading axis (``layers``, ``cycles``,
``enc_layers``, ``dec_layers``); the port keeps one dict a layer.
``port_leaf_axes`` maps a port leaf to its JAX counterpart's path and
gives it that leaf's axes without the leading ``"layers"`` entry, which
``resolve`` always maps to ``None``.  The rules are pure functions.

Placement (the port's ``jax.device_put`` and ``np.asarray``):
``device_put(tree, shardings)`` splits every leaf into its shards on the
mesh's devices, a ``ShardedTensor``; ``gather`` joins them back.  Shards
of a leaf that hold the same block on one device are one tensor (a mesh
may put many shards on one card, ``launch/mesh.py``); replicas on other
devices are copies.

Activations: model code calls ``constrain(x, "batch", "seq", "embed")`` at
the JAX package's call sites.  Without an activation mesh
(``use_activation_mesh``) it is the identity.  Under one, inside a data
group of the sharded step (``models/sharded.py``), it is where an
activation's layout over the model shards is made explicit: partial sums
are summed, a sharded dimension gathered or split.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

__all__ = [
    "LOGICAL_RULES", "PartitionSpec", "NamedSharding", "ShardedTensor",
    "logical_axes_for", "port_leaf_axes", "resolve", "param_shardings",
    "batch_shardings", "cache_shardings", "scalar_sharding",
    "use_activation_mesh", "activation_mesh", "constrain",
    "constrain_like_params", "kv_cache_mode", "device_put", "gather",
]

# logical axis → preferred mesh axis (None = replicate)
LOGICAL_RULES: Dict[str, Optional[str]] = {
    "batch": "data",          # extended to ('pod','data') on multi-pod meshes
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "rnn": "model",
    "experts": None,          # E=8 < axis 16: TP d_ff instead
    "embed": "data",          # FSDP / ZeRO param+optimizer sharding
    "vocab_table": "data",    # tok table rows (gather-friendly)
    "kv_seq": "model",        # KV-cache seq dim when kv_heads can't shard
    "head_dim": None,
    "layers": None,
    "seq": None,
    "enc_seq": None,
    "conv_w": None,
}


class PartitionSpec(tuple):
    """Mesh axes of each dimension (a name, a tuple of names, or None): the
    entries of ``jax.sharding.PartitionSpec``, which writes a one-name
    tuple as the name."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


# --------------------------------------------------------------------------
# the rules
# --------------------------------------------------------------------------
def logical_axes_for(path_str: str, shape: Tuple[int, ...],
                     cfg: ModelConfig) -> Tuple[Optional[str], ...]:
    """Logical axis names of one parameter leaf at ``path_str`` in the JAX
    package's layout (``layers/...``, ``cycles/0/...``, ``tail/1/...``)."""
    name = path_str.rsplit("/", 1)[-1]
    # scan-stacked param groups carry a leading layer/cycle dim
    stacked = any(seg in path_str for seg in
                  ("layers/", "enc_layers/", "dec_layers/", "cycles/")) \
        or path_str.startswith(("layers", "enc_layers", "dec_layers",
                                "cycles"))
    lead: Tuple[Optional[str], ...] = ("layers",) if stacked else ()
    core = shape[1:] if stacked else shape
    cnd = len(core)

    def out(*axes):
        assert len(axes) == cnd, (path_str, shape, axes)
        return lead + tuple(axes)

    # -- embeddings: tok over 'data' only (gather-friendly) -------------------
    if "embed" in path_str and name == "tok":
        return out("vocab_table", "embed")
    if "embed" in path_str and name == "out":
        return out("embed", "vocab")

    # -- MoE (before generic attention/MLP names — moe params share them) ---
    if "moe" in path_str:
        if name == "router":
            return out("embed", "experts")
        if name in ("wg", "wu") and cnd == 3:
            return out("experts", "embed", "ff")
        if name == "wo" and cnd == 3:
            return out("experts", "ff", "embed")

    # -- attention ----------------------------------------------------------
    if name == "wq" and cnd == 3:
        return out("embed", "heads", "head_dim")
    if name in ("wk", "wv") and cnd == 3:
        return out("embed", "kv_heads", "head_dim")
    if name == "wo" and cnd == 3:                  # attn out [H, hd, D]
        return out("heads", "head_dim", "embed")
    if name == "wo_gate" and cnd == 3:             # xlstm output gate
        return out("embed", "heads", "head_dim")
    if name in ("wz", "wi", "wf") and cnd == 3:    # xlstm projections
        return out("embed", "heads", "head_dim")
    if name in ("wi", "wf") and cnd == 2 and any(
            s in path_str for s in ("blocks", "cycles", "tail")):
        return out("embed", "heads")               # mlstm scalar gates

    # -- dense MLP -----------------------------------------------------------
    if name in ("wg", "wu", "wi") and cnd == 2:
        return out("embed", "ff")
    if name == "wo" and cnd == 2:
        return out("ff", "embed")

    # -- griffin recurrent block ---------------------------------------------
    if name in ("w_gate", "w_x") and cnd == 2:
        return out("embed", "rnn")
    if name == "w_out" and cnd == 2:
        return out("rnn", "embed")
    if name in ("wa",) and cnd == 2:
        return out("embed", "rnn")                 # [w, w]: FSDP × TP
    if name == "conv_w":
        return out("conv_w", "rnn")

    # -- 1-D / small leaves ---------------------------------------------------
    if cnd == 0:
        return out()
    if cnd == 1:
        # gate biases / norm scales over the rnn or ff width
        if name in ("conv_b", "ba", "bi", "lam"):
            return out("rnn")
        return out(None)
    if cnd == 2 and name == "bf":
        return out("heads", "head_dim")

    # -- fallback: shard the two largest trailing dims (data × model) --------
    if cnd >= 2:
        return lead + (None,) * (cnd - 2) + ("embed", "ff")
    return lead + (None,) * cnd


def _mesh_shape(mesh) -> Dict[str, int]:
    return dict(mesh.shape)


def _mesh_axes_for(logical: Optional[str], mesh):
    """Resolve one logical axis to a mesh axis (or a tuple for batch)."""
    if logical is None:
        return None
    shape = _mesh_shape(mesh)
    if logical == "batch":
        axes = tuple(a for a in ("pod", "data") if a in shape)
        return axes if axes else None
    m = LOGICAL_RULES.get(logical)
    if m is None or m not in shape:
        return None
    return m


def _axis_size(mesh, m) -> int:
    if m is None:
        return 1
    shape = _mesh_shape(mesh)
    if isinstance(m, tuple):
        return int(np.prod([shape[a] for a in m]))
    return shape[m]


def resolve(axes: Sequence[Optional[str]], shape: Tuple[int, ...],
            mesh) -> PartitionSpec:
    """Logical axes → PartitionSpec, dropping non-divisible bindings and
    duplicate mesh-axis uses (first binding wins).  ``mesh`` is anything
    with a ``shape`` mapping of axis sizes."""
    spec = []
    used = set()
    for dim, logical in zip(shape, axes):
        m = _mesh_axes_for(logical, mesh)
        if m is None:
            spec.append(None)
            continue
        flat = m if isinstance(m, tuple) else (m,)
        if used & set(flat):
            spec.append(None)
            continue
        size = _axis_size(mesh, m)
        if size <= 1 or dim % size != 0:
            spec.append(None)
            continue
        used.update(flat)
        spec.append(m)
    while spec and spec[-1] is None:
        spec.pop()
    return P(*spec)


# -- the port's leaves and their JAX counterparts ----------------------------
_STACKS = {"dense": ("layers",), "moe": ("layers",), "vlm": ("layers",),
           "audio": ("enc_layers", "dec_layers")}


def jax_leaf_path(cfg: ModelConfig, path: Sequence) -> Tuple[str, bool]:
    """(the JAX package's path of the port's parameter or cache leaf at
    ``path`` (its keys and list indices), whether that leaf is stacked on
    a leading layer axis there).  Griffin's and xLSTM's ``blocks/<i>`` are
    ``cycles/<i mod P>`` (stacked) for the full cycles and ``tail/<j>``
    after them; the transformer's ``layers/<i>`` is ``layers``, the
    encoder-decoder's ``enc_layers/<i>`` and ``dec_layers/<i>`` likewise;
    a decode cache's per-layer ``k``/``v`` sit under ``kv`` there."""
    parts = [str(p) for p in path]
    if cfg.family in ("hybrid", "ssm") and parts and parts[0] == "blocks":
        from repro_torch.models import griffin, xlstm
        mod = griffin if cfg.family == "hybrid" else xlstm
        P_ = len(mod.pattern_of(cfg))
        n_cycles, _ = mod._cycle_split(cfg)
        i = int(parts[1])
        if i < n_cycles * P_:
            return "/".join(["cycles", str(i % P_)] + parts[2:]), True
        return "/".join(["tail", str(i - n_cycles * P_)] + parts[2:]), False
    if parts and parts[0] in _STACKS.get(cfg.family, ()) and len(parts) > 1:
        return "/".join([parts[0]] + parts[2:]), True
    return "/".join(parts), False


def port_leaf_axes(cfg: ModelConfig, path: Sequence,
                   shape: Tuple[int, ...]) -> Tuple[Optional[str], ...]:
    """Logical axes of the port's parameter leaf at ``path``: its JAX
    counterpart's, without the leading ``"layers"`` entry of a stacked
    leaf."""
    jpath, stacked = jax_leaf_path(cfg, path)
    shape = tuple(shape)
    if stacked:
        return logical_axes_for(jpath, (1,) + shape, cfg)[1:]
    return logical_axes_for(jpath, shape, cfg)


# --------------------------------------------------------------------------
# shardings
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """A mesh and a ``PartitionSpec`` (``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: PartitionSpec

    def __eq__(self, other):
        return isinstance(other, NamedSharding) and self.mesh is other.mesh \
            and tuple(self.spec) == tuple(other.spec)

    def __hash__(self):
        return hash((id(self.mesh), tuple(self.spec)))

    def dim_axes(self, ndim: int) -> List[Tuple[str, ...]]:
        """The mesh axes each of ``ndim`` dimensions is split over."""
        out = []
        for d in range(ndim):
            e = self.spec[d] if d < len(self.spec) else None
            out.append(() if e is None else (e,) if isinstance(e, str)
                       else tuple(e))
        return out

    def block_of(self, shape: Sequence[int], pos: Tuple[int, ...]
                 ) -> Tuple[Tuple[int, int], ...]:
        """The ``(start, stop)`` of each dimension of ``shape`` the shard at
        mesh position ``pos`` holds."""
        names = list(self.mesh.axis_names)
        sizes = self.mesh.devices.shape
        block = []
        for n, axes in zip(shape, self.dim_axes(len(shape))):
            parts, idx = 1, 0
            for a in axes:
                k = names.index(a)
                parts, idx = parts * sizes[k], idx * sizes[k] + pos[k]
            if n % parts:
                raise ValueError(f"dimension {n} does not split into {parts} "
                                 f"shards ({self.spec})")
            step = n // parts
            block.append((idx * step, (idx + 1) * step))
        return tuple(block)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one shard of a leaf of ``shape``."""
        pos = (0,) * self.mesh.devices.ndim
        return tuple(b - a for a, b in self.block_of(shape, pos))


def _tree_map_paths(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map_paths(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map_paths(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def param_shardings(cfg: ModelConfig, mesh, param_shapes):
    """A ``NamedSharding`` tree matching ``param_shapes`` (the port's
    parameter tree, e.g. ``api.init_params(cfg, device="meta")``)."""
    def one(path, leaf):
        axes = port_leaf_axes(cfg, path, tuple(leaf.shape))
        return NamedSharding(mesh, resolve(axes, tuple(leaf.shape), mesh))
    return _tree_map_paths(one, param_shapes)


def scalar_sharding(mesh) -> NamedSharding:
    """Replicated on every shard."""
    return NamedSharding(mesh, P())


def _shape_of(leaf) -> Optional[Tuple[int, ...]]:
    """A leaf's shape; None for Python numbers (the caches' ``pos``)."""
    if isinstance(leaf, (bool, int, float)):
        return None
    return tuple(leaf.shape)


def batch_shardings(cfg: ModelConfig, mesh, specs):
    """Inputs: batch dim over ('pod','data') when divisible; the rest
    replicated.  Works for train/prefill batches (dicts of [B, ...]); a
    Python number is replicated."""
    def one(leaf):
        shape = _shape_of(leaf)
        if shape is None:
            return scalar_sharding(mesh)
        spec = resolve(("batch",) + (None,) * (len(shape) - 1), shape, mesh)
        return NamedSharding(mesh, spec)
    return _tree_map(one, specs)


def _kv_cache_axes(cfg: ModelConfig, mesh, lead: Tuple):
    """KV buffers [.., B, S, K, hd]: kv_heads over 'model' when divisible,
    else the cache's *sequence* dim over 'model'."""
    K = cfg.n_kv_heads
    msize = _mesh_shape(mesh).get("model", 1)
    if msize > 1 and K % msize == 0:
        return lead + ("batch", "seq", "kv_heads", "head_dim")
    return lead + ("batch", "kv_seq", None, "head_dim")


def cache_shardings(cfg: ModelConfig, mesh, cache_spec):
    """Decode caches in the port's layout (one state per layer): batch over
    ('pod','data'); KV buffers also over 'model' (kv_heads when divisible,
    else the sequence dim); recurrent states over 'model' on their width
    dims.  Per-layer leaves:

      [B, S, K, hd]     transformer / whisper / griffin-attn KV
      [B, cw-1, W]      griffin conv state        (W = rnn width)
      [B, W]            griffin RG-LRU state
      [B, H, dk(,dv)]   xlstm mLSTM/sLSTM states
      pos               an int, replicated
    """
    def one(path, leaf):
        shape = _shape_of(leaf)
        if shape is None or len(shape) == 0:
            return scalar_sharding(mesh)
        nd = len(shape)
        name = str(path[-1])
        if name in ("k", "v", "xk", "xv"):               # KV buffers
            axes = _kv_cache_axes(cfg, mesh, ())
        elif name == "conv":                             # [B, cw-1, W]
            axes = ("batch", None, "rnn")
        elif name == "h":                                # [B, W]
            axes = ("batch", "rnn")
        elif nd == 4 and shape[-1] == shape[-2]:         # mlstm C [B,H,d,d]
            axes = ("batch", "heads", None, None)
        elif nd == 3:                                    # xlstm n / sLSTM
            axes = ("batch", "heads", "head_dim")
        elif nd == 2:                                    # xlstm m [B,H]
            axes = ("batch", "heads")
        else:
            axes = ("batch",) + (None,) * (nd - 1)
        return NamedSharding(mesh, resolve(tuple(axes)[:nd], shape, mesh))
    return _tree_map_paths(one, cache_spec)


# --------------------------------------------------------------------------
# activation sharding constraints
# --------------------------------------------------------------------------
class _Active:
    """The activation mesh and data group in force.  Process-wide, not
    thread-local: the backward pass, which recomputes checkpointed layers
    under them, runs in autograd's device threads."""
    mesh = None
    group = None


_ACT = _Active()


@contextlib.contextmanager
def use_activation_mesh(mesh):
    """Make ``mesh`` the activation mesh of ``constrain`` for the block."""
    prev = getattr(_ACT, "mesh", None)
    _ACT.mesh = mesh
    try:
        yield
    finally:
        _ACT.mesh = prev


def activation_mesh():
    """The mesh of ``use_activation_mesh``, or None."""
    return getattr(_ACT, "mesh", None)


@contextlib.contextmanager
def use_group(group):
    """Run the block as one data group of the sharded step: ``constrain``
    hands activations to ``group.constrain`` (``models/sharded.py``)."""
    prev = getattr(_ACT, "group", None)
    _ACT.group = group
    try:
        yield
    finally:
        _ACT.group = prev


def active_group():
    """The data group of ``use_group``, or None."""
    return getattr(_ACT, "group", None)


def constrain(x, *axes: Optional[str]):
    """A logical-axis layout for an activation: the identity without an
    activation mesh, or outside a data group of the sharded step; inside
    one, ``x`` in the layout over the model shards that ``resolve`` gives
    these axes (partial sums summed, a dimension gathered or split)."""
    if activation_mesh() is None:
        return x
    group = active_group()
    if group is None:
        return x
    if len(axes) < x.ndim:
        axes = tuple(axes) + (None,) * (x.ndim - len(axes))
    return group.constrain(x, tuple(axes[:x.ndim]))


def constrain_like_params(tree, cfg: ModelConfig):
    """A params-shaped tree (e.g. gradients) in the parameters' own 2-D
    sharding: without an activation mesh the identity; with one, each
    plain tensor placed on it (``device_put``) and each ``ShardedTensor``
    of another layout re-placed."""
    mesh = activation_mesh()
    if mesh is None:
        return tree
    shapes = _tree_map(lambda l: torch.empty(tuple(l.shape), device="meta"), tree)
    shards = param_shardings(cfg, mesh, shapes)

    def one(leaf, s):
        if isinstance(leaf, ShardedTensor):
            if leaf.sharding == s:
                return leaf
            leaf = leaf.gather()
        return _put(leaf, s)
    return _tree_map(one, tree, shards)


def kv_cache_mode(cfg: ModelConfig) -> Optional[str]:
    """How the decode KV cache shards on the active mesh: 'heads' when
    kv_heads divides the model axis, else 'seq' (cache sequence dim over
    'model'; attention becomes partial softmax + tiny all-reduces).  None
    without a mesh."""
    mesh = activation_mesh()
    if mesh is None or _mesh_shape(mesh).get("model", 1) <= 1:
        return None
    return "heads" if cfg.n_kv_heads % _mesh_shape(mesh)["model"] == 0 \
        else "seq"


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------
Block = Tuple[Tuple[int, int], ...]


class ShardedTensor:
    """A global tensor split over a mesh by a ``NamedSharding``: the port's
    ``jax.Array`` with a sharding.  Each device holds the distinct blocks
    (the ``(start, stop)`` of every dimension) its mesh positions need,
    stacked in one tensor, its slab: ``slabs[device]`` is ``[n, *block
    shape]`` and ``rows[device][block]`` a block's row there.  Mesh
    positions that hold the same block on one device share that row;
    positions on other devices hold copies (replicas).  ``blocks`` maps
    each block to its row (a view) on each device that holds it, the
    first one its primary copy."""

    def __init__(self, sharding: NamedSharding, shape, dtype,
                 slabs: Dict[torch.device, torch.Tensor],
                 rows: Dict[torch.device, Dict[Block, int]]):
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.dtype = dtype if dtype is not None else \
            next(iter(slabs.values())).dtype
        self.slabs = slabs
        self.rows = rows

    # -- tensor-like metadata -------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.shape)

    def dim(self) -> int:
        return len(self.shape)

    @property
    def mesh(self):
        return self.sharding.mesh

    @property
    def device(self) -> torch.device:
        """The device of the first shard."""
        return next(iter(self.slabs))

    def __repr__(self):
        return (f"ShardedTensor({tuple(self.shape)}, {self.dtype}, "
                f"{self.sharding.spec}, {len(self.blocks)} blocks)")

    # -- shards ----------------------------------------------------------------
    @property
    def blocks(self) -> Dict[Block, Dict[torch.device, torch.Tensor]]:
        """Each block's row (a view of a slab) on each device holding it,
        devices in mesh order."""
        out: Dict[Block, Dict[torch.device, torch.Tensor]] = {}
        for dev, rows in self.rows.items():
            slab = self.slabs[dev]
            for block, i in rows.items():
                out.setdefault(block, {})[dev] = slab[i]
        return out

    def shard(self, pos: Tuple[int, ...]) -> torch.Tensor:
        """The tensor of the shard at mesh position ``pos``."""
        dev = self.mesh.devices[pos]
        return self.slabs[dev][self.rows[dev][self.sharding.block_of(self.shape, pos)]]

    def positions(self) -> Iterator[Tuple[int, ...]]:
        """Every mesh position, in order."""
        return np.ndindex(*self.mesh.devices.shape)

    def replicas(self) -> List[List[torch.Tensor]]:
        """Each distinct block's tensors, one a device that holds it (the
        first is the primary copy)."""
        return [list(d.values()) for d in self.blocks.values()]

    def primaries(self) -> List[torch.Tensor]:
        """Tensors holding each distinct block once: the one slab where a
        single device holds them all, else each block's primary copy."""
        if len(self.slabs) == 1:
            return list(self.slabs.values())
        return [r[0] for r in self.replicas()]

    def local_tensors(self) -> List[torch.Tensor]:
        """Every slab (one a device)."""
        return list(self.slabs.values())

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (None: the first shard's), from
        each block's primary copy."""
        device = self.device if device is None else torch.device(device)
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        with torch.no_grad():
            for block, copies in self.blocks.items():
                sl = tuple(slice(a, b) for a, b in block)
                out[sl] = next(iter(copies.values()))
        return out

    def map(self, fn) -> "ShardedTensor":
        """A new ShardedTensor of ``fn(slab)`` for every slab (``fn`` keeps
        the slab's shape)."""
        return ShardedTensor(self.sharding, self.shape, None,
                             {d: fn(t) for d, t in self.slabs.items()},
                             self.rows)


def _put(x, s: NamedSharding, dtype=None) -> ShardedTensor:
    """Split ``x`` (a tensor, array or number) into its shards under ``s``."""
    if isinstance(x, ShardedTensor):
        x = x.gather()
    t = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)
    if dtype is not None:
        t = t.to(dtype)
    mesh = s.mesh
    held: Dict[torch.device, set] = {}
    for pos in np.ndindex(*mesh.devices.shape):
        held.setdefault(mesh.devices[pos], set()).add(s.block_of(t.shape, pos))
    # a slab's rows in order of the model-split dimension, then the others:
    # a device holding every block gathers a model shard's part as a view
    dm = [d for d, ax in enumerate(s.dim_axes(t.dim())) if "model" in ax]
    rows: Dict[torch.device, Dict[Block, int]] = {
        dev: {b: i for i, b in enumerate(sorted(
            blocks, key=lambda b: (tuple(b[d] for d in dm), b)))}
        for dev, blocks in held.items()}
    slabs = {}
    with torch.no_grad():
        for dev, held in rows.items():
            slabs[dev] = torch.stack([t[tuple(slice(a, b) for a, b in block)]
                                      for block in held]).to(dev)
    return ShardedTensor(s, t.shape, t.dtype, slabs, rows)


def device_put(tree, shardings, donate: bool = False):
    """``tree`` (tensors, arrays, numbers) split into ``ShardedTensor``s
    under ``shardings`` (a matching tree of ``NamedSharding``s, or one for
    every leaf); a Python number stays as it is.  ``donate=True`` empties
    ``tree``'s containers leaf by leaf as the shards are made, so that a
    whole leaf is freed once its shards exist (the caller keeps no other
    reference)."""
    def walk(t, s):
        if isinstance(t, dict):
            out = {}
            for k in list(t.keys()):
                out[k] = walk(t[k], s[k] if not isinstance(s, NamedSharding) else s)
                if donate:
                    t[k] = None
            return out
        if isinstance(t, (list, tuple)):
            out = []
            for i in range(len(t)):
                out.append(walk(t[i], s[i] if not isinstance(s, NamedSharding) else s))
                if donate and isinstance(t, list):
                    t[i] = None
            return out
        if isinstance(t, (bool, int, float)) or t is None:
            return t
        return _put(t, s)
    return walk(tree, shardings)


def gather(tree, device=None):
    """Every ``ShardedTensor`` of ``tree`` joined back into one tensor on
    ``device`` (None: its first shard's); other leaves as they are."""
    return _tree_map(lambda l: l.gather(device) if isinstance(l, ShardedTensor)
                     else l, tree)


def zeros_like(leaf: ShardedTensor, dtype=None) -> ShardedTensor:
    """Zeros in ``leaf``'s blocks (``dtype`` default: its own)."""
    return leaf.map(lambda t: torch.zeros_like(t, dtype=dtype or t.dtype))
