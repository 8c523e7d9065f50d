"""The dry run of the port: what one step of every (arch × shape × mesh)
cell costs each device of the production meshes, accounted on a CPU (the
counterpart of the JAX package's ``launch/dryrun.py``).

The JAX dry run lowers and compiles each cell against 512 placeholder
host devices and walks the compiled HLO.  The port runs each cell's step
once on a mesh of ``meta`` shards (``launch/mesh.py``,
``devices=[torch.device("meta")]``: shapes only, nothing computed or
allocated) under an ``op_analysis.Account``, which walks its ops and
charges each device its share.  A step is the one a user runs:
``train_loop.compile_train_step`` (``n_microbatches`` the JAX rule: the
global batch over the data shards), ``compile_prefill_step`` below, or
``serving.serve_loop.compile_serve_step`` (sampling a token), its state
placed by the plan's shardings.  The account samples the step's loops
(microbatches, data groups: ``op_analysis.trips``).

``make_prefill_step(cfg)``: ``prefill(params, batch) -> logits [B, 1,
V]``, ``forward_hidden`` then the unembedding of the last position.
``compile_prefill_step(cfg, mesh, batch_specs)`` runs it over a mesh: the
params placed by ``sharding.param_shardings``, the batch split over the
data groups by ``sharding.batch_shardings``, one data group at a time on
its model shards (``models/sharded.py``), the logits returned as a
``ShardedTensor`` laid out ``("batch", None, "vocab")``.

``run_cell`` gives the JAX dry run's record.  Its keys where they name
HLO are renamed: ``hlo_walk`` is ``op_walk`` (``op_analysis.summarize``'s
keys, per device; ``executed``: the same for the whole process),
``lower_s``/``compile_s`` is ``account_s``, ``hlo_len`` is ``n_ops``
(the ops walked, loop trips counted); ``kernels`` counts the
hand-written kernels' launches the step makes.  ``memory`` holds the
argument, output, alias and temporary bytes of a device (``temp``: the
peak of the step's own allocations, one device's share) and
``per_device_total_bytes``; ``cost`` the per-device ``flops`` and
``bytes accessed``.  There is no ``--save-hlo`` and no ``hlo_path``.
``run_stencil_cell``: the acoustic ISO step at 1024³ f32 over the
production mesh (``core/distributed.py``, torch inner), with and without
overlap, or ``time_steps`` steps an exchange.

    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \\
        --out build/dryrun_torch.json
    python -m repro_torch.launch.dryrun --arch acoustic-iso --mesh both

prints a line a cell and a summary, writes only ``--out``, and exits 1 on
any error (a failing cell is an ``error`` record, never a skip).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import configs, sharding
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import SHAPES, applicable, input_specs
from repro_torch.launch import op_analysis
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.models import sharded as _sharded
from repro_torch.train.optimizer import tree_map

__all__ = ["make_prefill_step", "compile_prefill_step", "PrefillPlan",
           "account_cell", "run_cell", "account_stencil_cell", "run_stencil_cell",
           "main"]


def make_prefill_step(cfg: ModelConfig, use_kernel_conv: Optional[bool] = None):
    """→ ``prefill(params, batch) -> logits [B, 1, V]`` of the last
    position (in the compute dtype).  ``use_kernel_conv`` as in
    ``griffin.causal_conv``."""
    def prefill(params, batch):
        hid, _ = api.forward_hidden(cfg, params, batch, use_kernel_conv)
        return L.unembed(params["embed"], hid[:, -1:], cfg)
    return prefill


@dataclasses.dataclass
class PrefillPlan:
    """The sharded prefill step's in and out shardings, and the bytes of
    params and of batch each shard holds."""
    mesh: object
    param_shardings: object
    batch_shardings: object
    out_sharding: sharding.NamedSharding
    param_bytes_per_shard: int
    batch_bytes_per_shard: int


def compile_prefill_step(cfg: ModelConfig, mesh, batch_specs,
                         use_kernel_conv: Optional[bool] = None):
    """``make_prefill_step`` over ``mesh``: → ``(plan, step)``;
    ``step(params, batch) -> logits``, a ``ShardedTensor`` of ``[B, 1, V]``
    under ``plan.out_sharding``.  ``batch``: the global batch (numpy
    arrays or tensors), its rows split over the data groups;
    ``batch_specs`` its leaves' shapes.  K6 runs once a model shard."""
    groups = _sharded.groups(mesh)
    fn = make_prefill_step(cfg, use_kernel_conv)
    B = next(iter(batch_specs.values())).shape[0]
    out = sharding.NamedSharding(mesh, sharding.resolve(
        ("batch", None, "vocab"), (B, 1, cfg.vocab), mesh))
    pshapes = api.init_params(cfg, device="meta")
    pshard = sharding.param_shardings(cfg, mesh, pshapes)
    bshard = sharding.batch_shardings(cfg, mesh, batch_specs)
    plan = PrefillPlan(
        mesh=mesh, param_shardings=pshard, batch_shardings=bshard, out_sharding=out,
        param_bytes_per_shard=sharding.shard_bytes(pshapes, pshard),
        batch_bytes_per_shard=sharding.shard_bytes(batch_specs, bshard))

    def step(params, batch):
        batch = {k: torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
                 for k, v in batch.items()}
        n = next(iter(batch.values())).shape[0]
        if n % len(groups):
            raise ValueError(f"batch {n} does not split into {len(groups)} "
                             f"data groups")
        b = n // len(groups)
        dev0 = groups[0].first
        rows = []
        loop = op_analysis.trips(enumerate(groups))    # an account may sample it
        with torch.no_grad(), sharding.use_activation_mesh(mesh):
            for gi, g in loop:
                gb = {k: v[gi * b:(gi + 1) * b].to(g.first) for k, v in batch.items()}
                with sharding.use_group(g):
                    logits = fn(tree_map(g.view, params), gb)
                    if isinstance(logits, _sharded.Sharded):
                        logits = g.relayout(logits, None).parts[0]
                rows.append(logits.to(dev0))
        return sharding.device_put(torch.cat(loop.fill(rows)), out)

    return plan, step


# ---------------------------------------------------------------------------
# the accounted cells
# ---------------------------------------------------------------------------
META = torch.device("meta")
METRIC_BYTES = 4 * 4        # the train step's loss, aux, grad_norm, lr: f32


def _batch_shard_size(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        if a in mesh.shape:
            n *= mesh.shape[a]
    return n


def account_cell(arch, shape_name, multi_pod: bool,
                 overrides: Optional[Dict] = None, sample: bool = True,
                 mesh=None):
    """Run one (arch × shape × mesh) cell's step on meta shards under an
    account: → ``(account, meta, mesh, cfg)``.  ``arch``: a config name
    or a ``ModelConfig``; ``shape_name``: a name of ``SHAPES`` or a
    ``ShapeSpec``; ``overrides``: config fields (and ``n_microbatches``);
    ``sample=False`` runs every loop item; ``mesh`` replaces the
    production mesh (a meta mesh).  ``meta`` holds the step's name,
    ``memory``, ``arguments`` (a shard's bytes of each argument) and
    ``held_bytes`` (the arguments' bytes the process holds: every
    shard's, one copy of a block a device)."""
    from repro_torch.serving.serve_loop import compile_serve_step
    from repro_torch.train import train_loop
    from repro_torch.train.optimizer import OptConfig

    overrides = dict(overrides or {})
    n_mb_override = overrides.pop("n_microbatches", None)
    cfg = arch if isinstance(arch, ModelConfig) else configs.get(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, devices=[META])
    specs = input_specs(cfg, shape)
    acct = op_analysis.Account(mesh.size, sample=sample)

    if shape.kind == "train":
        n_mb = n_mb_override or max(1, shape.global_batch // _batch_shard_size(mesh))
        tc = train_loop.TrainConfig(opt=OptConfig(), n_microbatches=n_mb)
        plan, step = train_loop.compile_train_step(cfg, tc, mesh, specs)
        state = sharding.device_put(train_loop.state_specs(cfg), plan.in_shardings[0])
        with acct:
            step(state, specs)
        held = _held_bytes(state)
        args = {"state": plan.state_bytes_per_shard, "batch": plan.batch_bytes_per_shard}
        out = plan.state_bytes_per_shard + METRIC_BYTES
        alias = plan.state_bytes_per_shard
        meta = {"step": "train_step", "n_microbatches": n_mb}
    elif shape.kind == "prefill":
        plan, step = compile_prefill_step(cfg, mesh, specs)
        params = sharding.device_put(api.init_params(cfg, device=META),
                                     plan.param_shardings)
        with acct:
            step(params, specs)
        held = _held_bytes(params)
        args = {"params": plan.param_bytes_per_shard, "batch": plan.batch_bytes_per_shard}
        out = int(np.prod(plan.out_sharding.shard_shape(
            (shape.global_batch, 1, cfg.vocab)))) * getattr(torch, cfg.dtype).itemsize
        alias = 0
        meta = {"step": "prefill_step"}
    else:
        plan, step = compile_serve_step(cfg, mesh, specs["cache"], sample=True)
        params = sharding.device_put(api.init_params(cfg, device=META),
                                     plan.param_shardings)
        cache = sharding.device_put(specs["cache"], plan.cache_shardings)
        gen = torch.Generator(device="cpu").manual_seed(0)
        with acct:
            step(params, cache, specs["tokens"], gen)
        held = _held_bytes((params, cache))
        args = {"params": plan.param_bytes_per_shard, "cache": plan.cache_bytes_per_shard,
                "tokens": plan.token_bytes_per_shard}
        out = plan.token_bytes_per_shard + plan.cache_bytes_per_shard
        alias = plan.cache_bytes_per_shard
        meta = {"step": "serve_step"}
    meta["memory"] = _memory(sum(args.values()), out, alias, acct.temp_bytes)
    meta["arguments"], meta["held_bytes"] = args, held
    return acct, meta, mesh, cfg


def _held_bytes(tree) -> int:
    """Bytes of every shard's tensors of ``tree``'s ``ShardedTensor``s, one
    copy of a block a device (what one process holds)."""
    if isinstance(tree, dict):
        return sum(_held_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_held_bytes(v) for v in tree)
    if isinstance(tree, sharding.ShardedTensor):
        return sum(t.numel() * t.element_size() for t in tree.local_tensors())
    return 0


def _memory(arg: int, out: int, alias: int, temp: float) -> Dict:
    m = {"argument_size_in_bytes": int(arg), "output_size_in_bytes": int(out),
         "alias_size_in_bytes": int(alias), "temp_size_in_bytes": int(round(temp))}
    m["per_device_total_bytes"] = (m["argument_size_in_bytes"] + m["output_size_in_bytes"]
                                   - m["alias_size_in_bytes"] + m["temp_size_in_bytes"])
    return m


def _walk_fields(acct: op_analysis.Account) -> Dict:
    pd = acct.per_device
    return {"cost": {"flops": float(pd.total_flops), "bytes accessed": float(pd.hbm_bytes)},
            "op_walk": op_analysis.summarize(pd),
            "executed": {**op_analysis.summarize(acct.executed),
                         "temp_bytes": float(acct.executed_temp_bytes)},
            "kernels": dict(acct.kernels), "n_ops": int(round(acct.n_ops))}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: Optional[Dict] = None, tag: str = "") -> Dict:
    """One cell's record (the JAX dry run's keys, renamed where they name
    HLO): ``skipped`` where ``applicable`` says so, ``error`` with the
    traceback where the step fails."""
    mesh_name = "multi" if multi_pod else "single"
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "seq_len": shape.seq_len, "global_batch": shape.global_batch,
           "kind": shape.kind, "tag": tag}
    ok, reason = applicable(cfg, shape)
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = reason
        return rec
    try:
        t0 = time.perf_counter()
        acct, meta, mesh, cfg2 = account_cell(arch, shape_name, multi_pod, overrides)
        meta.pop("arguments")
        meta.pop("held_bytes")
        rec.update(meta)
        rec.update({"status": "ok", "n_devices": mesh.size,
                    "account_s": round(time.perf_counter() - t0, 2),
                    **_walk_fields(acct),
                    "model_params": api.param_count(cfg2),
                    "active_params": api.active_param_count(cfg2)})
    except Exception as e:  # a failing cell is a bug — record loudly
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def account_stencil_cell(multi_pod: bool, grid_n: int = 1024,
                         overlap: bool = True, time_steps: int = 1, mesh=None):
    """The paper-side cell: the acoustic ISO step (``time_steps`` > 1:
    that many steps an exchange, time skewing) domain-decomposed over the
    production mesh (``mesh``: another meta mesh), ``grid_n``³ f32 grids,
    the torch lowering as each shard's pass: → ``(account, meta, mesh)``.
    The kernels' halo traffic is the same as the lowering's."""
    from repro_torch.core import acoustic, distributed as dist, dsl as st
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, devices=[META])
    k = acoustic.acoustic_iso_kernel
    grid_axes = ("pod", "data", "model") if multi_pod else ("data", "model", None)
    if time_steps > 1:
        backend = st.distributed(grid_axes=grid_axes, overlap=False,
                                 time_steps=time_steps, swap=("p0", "p1"))
    else:
        backend = st.distributed(grid_axes=grid_axes, overlap=overlap)
    shape = (grid_n,) * 3
    halos = {g: k.info.halo for g in k.ir.grid_params}
    fn = dist.lower_distributed(k.ir, halos, shape, None, backend, mesh)
    interiors = {g: torch.empty(shape, dtype=torch.float32, device=META)
                 for g in k.ir.grid_params}
    acct = op_analysis.Account(mesh.size)
    with acct, _charged_exchanges(fn.layout, acct):
        fn(interiors, {"dt": 1e-3})
    nbytes = 4 * int(np.prod(fn.local_shape)) * len(k.ir.grid_params)
    return acct, {"step": "stencil_step", "overlap": overlap, "time_steps": time_steps,
                  "grid": list(shape), "spec": fn.spec,
                  "memory": _memory(nbytes, nbytes, nbytes, acct.temp_bytes)}, mesh


@contextlib.contextmanager
def _charged_exchanges(layout, acct: op_analysis.Account):
    """Inside the block, each round of ``layout``'s slab copies is charged
    to ``acct``: a slab a collective-permute of its bytes on every shard
    (``HaloExchange.nbytes``), as ``HaloSpec.window_collective_bytes``
    prices it."""
    run = layout.exchange

    def exchange(bufs, exchanges):
        for ex in exchanges:
            acct.record("collective-permute",
                        ex.nbytes(bufs[0][ex.grid].element_size(), layout.batch),
                        2, devices=layout.n)
        return run(bufs, exchanges)
    layout.exchange = exchange
    try:
        yield
    finally:
        del layout.exchange


def run_stencil_cell(multi_pod: bool, grid_n: int = 1024, overlap: bool = True,
                     tag: str = "", time_steps: int = 1) -> Dict:
    """The stencil cell's record (``run_cell``'s keys)."""
    from repro_torch.core import acoustic
    mesh_name = "multi" if multi_pod else "single"
    rec = {"arch": f"acoustic-iso-{grid_n}", "shape": "one_step",
           "mesh": mesh_name, "seq_len": grid_n, "global_batch": 1,
           "kind": "stencil", "tag": tag}
    try:
        t0 = time.perf_counter()
        acct, meta, mesh = account_stencil_cell(multi_pod, grid_n, overlap, time_steps)
        meta.pop("spec")
        rec.update(meta)
        rec.update({"status": "ok", "n_devices": mesh.size,
                    "account_s": round(time.perf_counter() - t0, 2),
                    **_walk_fields(acct),
                    "stencil_flops_per_point": acoustic.acoustic_iso_kernel.info.flops_per_point})
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the port's dry run on meta shards")
    ap.add_argument("--arch", default="all",
                    help="arch id, 'all', or 'acoustic-iso' (stencil cells)")
    ap.add_argument("--shape", default="all", help="shape name or 'all'")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default=None, help="output JSON path")
    args = ap.parse_args(argv)

    archs = list(configs.ARCH_NAMES) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    t_all = time.perf_counter()
    records = []
    if args.arch == "acoustic-iso":
        for multi in meshes:
            for overlap in (True, False):
                rec = run_stencil_cell(multi, overlap=overlap,
                                       tag="" if overlap else "-no-overlap")
                records.append(rec)
                hw = rec.get("op_walk") or {}
                print(f"[{rec['status']:7s}] {rec['arch']:18s} overlap={overlap} "
                      f"{rec['mesh']:6s} "
                      f"account={rec.get('account_s', '-'):>8} "
                      f"mem/dev={_fmt_bytes((rec.get('memory') or {}).get('per_device_total_bytes')):>9} "
                      f"flops/dev={_fmt(hw.get('total_flops')):>10} "
                      f"coll/dev={_fmt_bytes(hw.get('total_collective_bytes')):>9} "
                      f"{rec.get('error', '')}", flush=True)
        archs = []
    for arch in archs:
        for shape in shapes:
            for multi in meshes:
                rec = run_cell(arch, shape, multi)
                records.append(rec)
                mem = (rec.get("memory") or {}).get("per_device_total_bytes")
                flops = (rec.get("op_walk") or {}).get("total_flops")
                col = (rec.get("op_walk") or {}).get("total_collective_bytes")
                print(f"[{rec['status']:7s}] {arch:18s} {shape:12s} "
                      f"{rec['mesh']:6s} "
                      f"account={rec.get('account_s', '-'):>7} "
                      f"mem/dev={_fmt_bytes(mem):>9} "
                      f"flops/dev={_fmt(flops):>10} "
                      f"coll/dev={_fmt_bytes(col):>9} "
                      f"{rec.get('reason', '') or rec.get('error', '')}",
                      flush=True)

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {args.out}")
    n_err = sum(r["status"] == "error" for r in records)
    print(f"{len(records)} cells: "
          f"{sum(r['status'] == 'ok' for r in records)} ok, "
          f"{sum(r['status'] == 'skipped' for r in records)} skipped, "
          f"{n_err} errors; {time.perf_counter() - t_all:.1f} s")
    return 1 if n_err else 0


def _fmt(x):
    if x is None:
        return "-"
    for unit in ("", "K", "M", "G", "T", "P", "E"):
        if abs(x) < 1000:
            return f"{x:.1f}{unit}"
        x /= 1000
    return f"{x:.1f}Z"


def _fmt_bytes(x):
    if x is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(x) < 1024:
            return f"{x:.1f}{unit}"
        x /= 1024
    return f"{x:.1f}PB"


if __name__ == "__main__":
    raise SystemExit(main())
