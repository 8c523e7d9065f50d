"""The port's dry run (``launch/dryrun.py``, ``launch/op_analysis.py``)
against the JAX package's: the JAX steps lowered, compiled and walked by
``hlo_analysis.analyze`` on an 8-device host mesh (a subprocess, as
``tests/test_dryrun.py`` runs them; the mesh built here with ``Auto``
axes, since JAX 0.9's ``jax.make_mesh`` defaults to ``Explicit`` ones,
which the package's sharding constraints refuse), the port's on a (4, 2)
mesh of meta shards.  Tiny configs, B = 8, S = 64, 2 microbatches.

Run as a script it prints the comparison table of every cell.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec, input_specs  # noqa: E402
from repro_torch.core import acoustic  # noqa: E402
from repro_torch.launch import dryrun, op_analysis as oa  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
META = torch.device("meta")
B, S, N_MB, GRID = 8, 64, 2, 64
ARCHS = ("granite-8b", "mixtral-8x7b", "pixtral-12b", "xlstm-1.3b",
         "whisper-small", "recurrentgemma-9b")
KINDS = ("train", "prefill", "decode")
STENCILS = {"overlap": (True, 1), "no-overlap": (False, 1), "time-skewed": (False, 2)}
# the JAX walks, split over processes that run at once
JAX_JOBS = (("xlstm-1.3b", "granite-8b"), ("whisper-small", "pixtral-12b"),
            ("recurrentgemma-9b", "mixtral-8x7b", "stencil"))

_JAX = r'''
import json, re, sys
import jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding
from repro import configs, sharding
from repro.configs.shapes import ShapeSpec, input_specs
from repro.launch import hlo_analysis
from repro.models import api
from repro.models import layers as L
from repro.serving.serve_loop import make_serve_step
from repro.train import train_loop
from repro.train.optimizer import OptConfig

B, S, N_MB, GRID = %d, %d, %d, %d
mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}

def collectives(text):
    """Each collective of the step: [kind, group size, bytes moved, trips,
    op_name] (the walk's ring model and trip counts)."""
    H = hlo_analysis
    comps = H._split_computations(text)
    trips = {}

    def visit(name, k):
        if name not in comps:
            return
        trips[name] = trips.get(name, 0) + k
        for inst in comps[name].insts:
            if inst.op == "while":
                body = re.search(r"body=%%?([\w\.\-]+)", inst.attrs).group(1)
                cond = re.search(r"condition=%%?([\w\.\-]+)", inst.attrs).group(1)
                visit(body, k * H._trip_count(comps[cond]))
            else:
                for c in H._CALLED_RE.findall(inst.attrs):
                    visit(c, k)
    visit(H._entry_name(text), 1)
    rows = []
    for name, comp in comps.items():
        for inst in comp.insts:
            base = inst.op[:-6] if inst.op.endswith("-start") else inst.op
            if base in H._COLLECTIVES and trips.get(name):
                g = H._group_size(inst.attrs, 8)
                m = re.search(r'op_name="([^"]*)"', inst.attrs)
                rows.append([base, g, H._coll_moved(base, H._bytes_of(inst.result_shapes), g),
                             trips[name], m.group(1) if m else ""])
    return rows

def walk(name, lowered):
    c = lowered.compile()
    m = c.memory_analysis()
    text = c.as_text()
    out[name] = {**hlo_analysis.summarize(hlo_analysis.analyze(text, 8)),
                 **{k: int(getattr(m, k)) for k in (
                     "argument_size_in_bytes", "output_size_in_bytes",
                     "alias_size_in_bytes", "temp_size_in_bytes")},
                 "collectives": collectives(text)}

for arch in sys.argv[1:]:
    if arch == "stencil":
        from repro.core import acoustic, distributed as dist, dsl as st
        k = acoustic.acoustic_iso_kernel
        halos = {g: k.info.halo for g in k.ir.grid_params}
        for name, (overlap, steps) in {"overlap": (True, 1), "no-overlap": (False, 1),
                                       "time-skewed": (False, 2)}.items():
            if steps > 1:
                be = st.distributed(grid_axes=("data", "model", None), overlap=False,
                                    time_steps=steps, swap=("p0", "p1"))
            else:
                be = st.distributed(grid_axes=("data", "model", None), overlap=overlap)
            with sharding.use_activation_mesh(mesh):
                fn = dist.lower_distributed(k.ir, halos, (GRID,) * 3, None, be, mesh)
                walk("stencil/" + name, fn.jitted.lower(
                    {g: jax.ShapeDtypeStruct((GRID,) * 3, jnp.float32)
                     for g in k.ir.grid_params},
                    {"dt": jax.ShapeDtypeStruct((), jnp.float32)}))
        continue
    cfg = configs.tiny(configs.get(arch))
    pshapes = api.param_shapes(cfg)
    pshard = sharding.param_shardings(cfg, mesh, pshapes)
    for kind in ("train", "prefill", "decode"):
        specs = input_specs(cfg, ShapeSpec("t", kind, S, B))
        if kind == "train":
            tc = train_loop.TrainConfig(opt=OptConfig(), n_microbatches=N_MB)
            with mesh:
                lowered, _ = train_loop.compile_train_step(cfg, tc, mesh, specs)
        elif kind == "prefill":
            def fn(params, batch):
                hid, _ = api.forward_hidden(cfg, params, batch)
                return L.unembed(params["embed"], hid[:, -1:], cfg)
            bshard = sharding.batch_shardings(cfg, mesh, specs)
            ospec = sharding.resolve(("batch", None, "vocab"), (B, 1, cfg.vocab), mesh)
            with mesh, sharding.use_activation_mesh(mesh):
                lowered = jax.jit(fn, in_shardings=(pshard, bshard),
                                  out_shardings=NamedSharding(mesh, ospec)
                                  ).lower(pshapes, specs)
        else:
            step = make_serve_step(cfg, sample=True)
            cshard = sharding.cache_shardings(cfg, mesh, specs["cache"])
            tshard = NamedSharding(mesh, sharding.resolve(("batch", None), (B, 1), mesh))
            with mesh, sharding.use_activation_mesh(mesh):
                lowered = jax.jit(
                    step, in_shardings=(pshard, cshard, tshard,
                                        sharding.scalar_sharding(mesh)),
                    out_shardings=(tshard, cshard), donate_argnums=(1,)
                ).lower(pshapes, specs["cache"],
                        jax.ShapeDtypeStruct((B, 1), jnp.int32),
                        jax.ShapeDtypeStruct((2,), jnp.uint32))
        walk(arch + "/" + kind, lowered)
print(json.dumps(out))
''' % (B, S, N_MB, GRID)


def _start_jax():
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(REPO, "src"))
    return [subprocess.Popen([sys.executable, "-c", _JAX, *job], env=env, text=True,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE)
            for job in JAX_JOBS]


def _collect(procs):
    out = {}
    for p in procs:
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, f"stdout:\n{stdout[-3000:]}\nstderr:\n{stderr[-3000:]}"
        out.update(json.loads(stdout.strip().splitlines()[-1]))
    return out


@pytest.fixture(scope="module")
def jax_procs():
    """The JAX walks, started with the module's first test."""
    procs = _start_jax()
    yield procs
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def jax_walk(jax_procs):
    return _collect(jax_procs)


@pytest.fixture(autouse=True, scope="module")
def _jax_first(jax_procs):
    """Start the JAX subprocesses before the tests that need no JAX."""


def _mesh():
    return mesh_mod.make_mesh((4, 2), ("data", "model"), devices=[META])


def _cfg(arch):
    return configs.tiny(configs.get(arch))


_PORT = {}


def port(arch, kind, sample=True):
    """The port's account of one tiny cell on the (4, 2) meta mesh (cached)."""
    key = (arch, kind, sample)
    if key not in _PORT:
        shape = ShapeSpec("t", kind, S, B)
        over = {"n_microbatches": N_MB} if kind == "train" else {}
        acct, meta, _, _ = dryrun.account_cell(_cfg(arch), shape, False, over,
                                               sample=sample, mesh=_mesh())
        _PORT[key] = (acct, meta)
    return _PORT[key]


def _row(name, acct, meta, jx):
    pd = oa.summarize(acct.per_device)
    cols = [("dot", pd["dot_flops"], jx["dot_flops"]),
            ("vec", pd["vec_flops"], jx["vec_flops"]),
            ("trans", pd["transcendentals"], jx["transcendentals"]),
            ("hbm", pd["hbm_bytes"], jx["hbm_bytes"]),
            ("coll", pd["total_collective_bytes"], jx["total_collective_bytes"]),
            ("arg", meta["memory"]["argument_size_in_bytes"], jx["argument_size_in_bytes"]),
            ("temp", meta["memory"]["temp_size_in_bytes"], jx["temp_size_in_bytes"])]
    return f"{name}: " + ", ".join(f"{k} port {a:.0f} jax {b:.0f}" for k, a, b in cols) \
        + f"; collectives port {pd['collective_counts']} jax {jx['collective_counts']}"


# -- no JAX needed -------------------------------------------------------------------
def test_scaled_account_equals_full_run():
    """Sampling the microbatch and data-group loops (one item charged for
    each) gives the full run's account on a 2-microbatch cell."""
    full, _ = port("granite-8b", "train", sample=False)
    scaled, _ = port("granite-8b", "train", sample=True)
    for part in ("per_device", "executed"):
        assert oa.summarize(getattr(scaled, part)) == oa.summarize(getattr(full, part)), part
    assert scaled.n_ops == full.n_ops


def test_scaled_account_counts_every_k6_launch():
    """Griffin's K6: forward, dx and (for the rest of the step's layers)
    each once a recurrent layer, model shard, data group and microbatch,
    sampled or not."""
    full, _ = port("recurrentgemma-9b", "train", sample=False)
    scaled, _ = port("recurrentgemma-9b", "train", sample=True)
    cfg = _cfg("recurrentgemma-9b")
    from repro_torch.models import griffin
    n_rec = griffin.block_types(cfg).count("rec")
    want = (3 if cfg.remat else 2) * n_rec * 2 * 4 * N_MB
    assert full.kernels == scaled.kernels == {"causal_conv1d": want}


def _hand_by_leaf(cfg, mesh):
    """Per parameter leaf of a tiny dense config's train step on ``mesh``,
    by hand from the placement: (path, its all-gather, reduce-scatter and
    all-reduce bytes a device, a microbatch).  Every parameter is gathered
    over the data axes once a microbatch (its block of ``n`` pieces:
    ``(n-1)/n`` of it moved), the unembedding again where the loss's
    sequence chunks are recomputed in the backward pass; its gradient is
    reduce-scattered back (``n-1`` pieces moved), and a piece that several
    data groups hold (a norm's, held whole by each) is all-reduced over
    them."""
    from repro_torch import sharding
    from repro_torch.models import api
    m, n_data = mesh.shape["model"], mesh.shape["data"]
    params = api.init_params(cfg, device=META)
    shard = sharding.param_shardings(cfg, mesh, params)
    for path, leaf, s in _named(params, shard):
        axes = s.dim_axes(leaf.dim())
        split_m = any("model" in a for a in axes)
        pieces = 1
        for a in axes:
            if "data" in a:
                pieces *= n_data
        block = leaf.numel() * leaf.element_size() // (m if split_m else 1)
        uses = 2 if cfg.logits_chunk and path == ("embed", "out") else 1
        yield (path, uses * oa._coll_moved("all-gather", block, pieces),
               oa._coll_moved("reduce-scatter", block // pieces, pieces),
               oa._coll_moved("all-reduce", block // pieces, n_data // pieces))


def _hand_train_collectives(cfg, mesh):
    """A tiny dense config's train step on ``mesh``, by hand from the
    placement: the parameters' collectives (``_hand_by_leaf``), and the
    activations'.  In the forward pass each layer's two products with a
    model-split contraction (attention out, MLP down) are f32 partials
    summed, and the vocab-split loss's logsumexp and label gather are f32
    all-reduces over the padded sequence (again in each chunk's
    recompute).  In the backward pass the gradient of each replicated
    activation the model shards' products read (the attention's and the
    MLP's normalized inputs, the loss chunk's input) is an all-reduce in
    the compute dtype."""
    m, n = mesh.shape["model"], mesh.shape["data"]
    b = B // (n * N_MB)
    chunked = bool(cfg.logits_chunk)
    S_pad = -(-S // cfg.logits_chunk) * cfg.logits_chunk if chunked else S
    ag = rs = ar_grad = 0.0
    for _, a_g, r_s, a_r in _hand_by_leaf(cfg, mesh):
        ag, rs, ar_grad = ag + a_g, rs + r_s, ar_grad + a_r
    itemsize = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    ar = lambda nbytes: oa._coll_moved("all-reduce", nbytes, m)  # noqa: E731
    act = b * S * cfg.d_model
    fwd = cfg.n_layers * 2 * ar(act * 4) + (2 if chunked else 1) * 2 * ar(b * S_pad * 4)
    bwd = 2 * cfg.n_layers * ar(act * itemsize) + ar(b * S_pad * cfg.d_model * itemsize)
    return {"all-gather": N_MB * ag, "reduce-scatter": N_MB * rs,
            "all-reduce": N_MB * (fwd + bwd + ar_grad)}


def _named(tree, other, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, other[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, other[i], path + (i,))
    else:
        yield path, tree, other


def test_dense_train_collectives_by_hand():
    cfg = _cfg("granite-8b")
    assert not cfg.remat and not cfg.tie_embeddings
    acct, _ = port("granite-8b", "train")
    want = _hand_train_collectives(cfg, _mesh())
    got = acct.per_device.coll_bytes
    assert set(got) == set(want), (got, want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), (k, got, want)


def test_dense_train_collectives_vs_jax_by_kind(jax_walk):
    """Why granite's train step moves fewer collective bytes in the port
    than in XLA's step, checked kind by kind against the JAX walk's own
    collectives (op names and trip counts).  All-gather: XLA gathers each
    layer's weights in the forward pass and again in the backward pass
    (the transpose re-gathers what the forward gathered), the port once a
    microbatch, keeping the gathered block for the backward pass.
    Gradient reduction: XLA all-reduces each gradient over the 4 data
    devices where the port reduce-scatters it (by the ring model an
    all-reduce moves twice a reduce-scatter's bytes); the norms' gradients,
    which every data group holds whole, are all-reduced on both sides.
    The rest (printed): XLA's collective-permutes move the vocab-split
    logits of a loss chunk to take each label's logit (``take_along_axis``),
    where the port gathers the label in each shard and all-reduces one f32
    a position; XLA's embedding lookup and its gradient go through
    all-reduces, collective-permutes and all-gathers, where the port
    gathers the table over the data axes and reduce-scatters its
    gradient."""
    cfg = _cfg("granite-8b")
    acct, _ = port("granite-8b", "train")
    rows = jax_walk["granite-8b/train"]["collectives"]
    assert sum(r[2] * r[3] for r in rows) == jax_walk["granite-8b/train"][
        "total_collective_bytes"]

    def jax_sum(kind, *within, g=4, but=()):
        return sum(r[2] * r[3] for r in rows if r[0] == kind and r[1] == g
                   and all(w in r[4] for w in within) and not any(b in r[4] for b in but))
    # the layers' products (the unembedding's, ``bsd,dv->bsv``, apart)
    ag_fwd = jax_sum("all-gather", "jvp()/while/body/closed_call/", "dot_general",
                     but=("transpose(", "checkpoint", "bsd,dv->bsv"))
    ag_bwd = jax_sum("all-gather", "transpose(jvp())/", "dot_general",
                     but=("checkpoint",))
    grad_ar = jax_sum("all-reduce", "transpose(jvp())/")
    hand = {path: (a_g, r_s, a_r) for path, a_g, r_s, a_r in _hand_by_leaf(cfg, _mesh())}
    port_layers_ag = N_MB * sum(v[0] for p, v in hand.items() if p[0] == "layers")
    port_grad = N_MB * sum(2 * v[1] + v[2] for p, v in hand.items()
                           if p != ("embed", "tok"))
    pd = acct.per_device
    msg = (f"port {pd.coll_bytes}, jax {jax_walk['granite-8b/train']['collective_bytes']}; "
           f"jax layer all-gathers fwd {ag_fwd} bwd {ag_bwd}, gradient all-reduces "
           f"{grad_ar}; port layer all-gathers {port_layers_ag}, 2 x reduce-scatter + "
           f"all-reduce of the gradients {port_grad}; jax collective-permutes of "
           f"take_along_axis {jax_sum('collective-permute', 'take_along_axis', g=8)}")
    assert ag_fwd == ag_bwd == port_layers_ag, msg
    assert grad_ar == port_grad, msg


def test_run_cell_production_record():
    """``run_cell`` on the production mesh (two layers): an ``ok`` record
    with the JAX dry run's keys (renamed where they name HLO)."""
    rec = dryrun.run_cell("granite-8b", "decode_32k", False, overrides={"n_layers": 2})
    assert rec["status"] == "ok", rec.get("traceback")
    for k in ("arch", "shape", "mesh", "seq_len", "global_batch", "kind", "tag",
              "status", "n_devices", "memory", "cost", "model_params",
              "active_params", "step", "op_walk", "account_s", "n_ops", "executed",
              "kernels"):
        assert k in rec, k
    assert rec["n_devices"] == 256 and rec["step"] == "serve_step"
    assert set(rec["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes",
                                  "alias_size_in_bytes", "temp_size_in_bytes",
                                  "per_device_total_bytes"}
    assert set(rec["cost"]) == {"flops", "bytes accessed"}
    assert rec["op_walk"]["dot_flops"] > 0 and rec["op_walk"]["total_collective_bytes"] > 0
    assert rec["model_params"] > 0 and rec["active_params"] == rec["model_params"]


def test_run_cell_skips_long_context_on_full_attention():
    rec = dryrun.run_cell("granite-8b", "long_500k", False)
    assert rec["status"] == "skipped" and "full-attention" in rec["reason"]


def test_run_cell_records_an_error():
    rec = dryrun.run_cell("granite-8b", "train_4k", False,
                          overrides={"n_microbatches": 3, "n_layers": 1})
    assert rec["status"] == "error" and "does not split" in rec["error"]
    assert "traceback" in rec


def test_cli_one_cell(tmp_path, capsys):
    out = tmp_path / "dry.json"
    rc = dryrun.main(["--arch", "acoustic-iso", "--mesh", "single", "--out", str(out)])
    text = capsys.readouterr().out
    assert rc == 0, text
    recs = json.loads(out.read_text())
    assert [r["status"] for r in recs] == ["ok", "ok"]
    assert [r["overlap"] for r in recs] == [True, False]
    assert "2 cells: 2 ok, 0 skipped, 0 errors" in text
    assert recs[0]["stencil_flops_per_point"] == acoustic.acoustic_iso_kernel.info.flops_per_point


def test_prefill_step_takes_use_kernel_conv_on_every_family():
    """``compile_prefill_step(..., use_kernel_conv=False)`` on a family
    without a temporal conv (it raised ``TypeError`` once)."""
    cfg = _cfg("granite-8b")
    specs = input_specs(cfg, ShapeSpec("t", "prefill", S, B))
    from repro_torch import sharding
    from repro_torch.models import api
    plan, step = dryrun.compile_prefill_step(cfg, _mesh(), specs, use_kernel_conv=False)
    params = sharding.device_put(api.init_params(cfg, device=META), plan.param_shardings)
    out = step(params, specs)
    assert tuple(out.shape) == (B, 1, cfg.vocab)


# -- against the JAX walk ------------------------------------------------------------
def _tied_unembed(cfg, kind):
    """The products of a tied unembedding a device computes in XLA's
    sharded step, which the port computes whole on every model shard (its
    table is replicated over them; on one card that is one product a
    device, and splitting it there was slower): 2·T·D·V a product over
    the vocab-split shards, T a data group's positions (training: the
    sequence padded to the loss's chunk; forward, the chunk's recompute,
    and the gradients of both operands), summed over the groups and
    microbatches, a device's share of it."""
    if not cfg.tie_embeddings:
        return 0
    b = B // 4 // (N_MB if kind == "train" else 1)
    if kind == "train":
        C = cfg.logits_chunk
        T, products = (b * -(-S // C) * C, 4) if C else (b * S, 3)
        passes = 4 * N_MB
    else:
        T, products, passes = b, 1, 4
    return products * 2 * T * cfg.d_model * cfg.vocab * passes // 8


def _moe_dispatch_combine(cfg, kind):
    """The FLOPs of one of the JAX package's MoE dispatch and combine
    einsums (``ngec,ngd->encd``, ``ngec,encd->ngd``: 2·n·G·E·C·D each,
    every model shard the whole) in one data group's pass, which the port
    does with ``index_add`` and a gather."""
    m = cfg.moe
    tokens = B * S // (4 * (N_MB if kind == "train" else 1))
    G = min(m.group_size, tokens)
    n, E = tokens // G, m.n_experts
    C = max(int(m.capacity_factor * G * m.top_k / E + 0.5), 1)
    return 2 * n * G * E * C * cfg.d_model


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_dot_flops_vs_jax(jax_walk, arch, kind):
    acct, meta = port(arch, kind)
    jx = jax_walk[f"{arch}/{kind}"]
    msg = _row(f"{arch}/{kind}", acct, meta, jx)
    cfg = _cfg(arch)
    got, want = acct.per_device.dot_flops, jx["dot_flops"] + _tied_unembed(cfg, kind)
    if arch != "xlstm-1.3b" and cfg.moe is None:
        assert got == want, msg
    elif cfg.moe is not None and kind != "decode":
        # the port dispatches and combines without products; in training
        # it runs a statistics pass (a forward) first, and JAX's backward
        # has three of those products (combine: both operands; dispatch:
        # the tokens), its forward two; a MoE layer each
        dc = _moe_dispatch_combine(cfg, kind) * cfg.n_layers * 2 / 8 * \
            (4 * N_MB if kind == "train" else 4)
        if kind == "train":
            stats = _stats_pass_dot_flops(arch)
            assert got - stats + 5 * dc == want, msg
        else:
            assert got + 2 * dc == want, msg
    elif cfg.moe is not None:
        # decode, dropless (C = G·K slots an expert): JAX routes the global
        # batch's 8 tokens as one group, the port each data group's 2; the
        # expert products differ with C, and JAX's dispatch and combine
        # are products (``_moe_decode``)
        assert got - _moe_decode(cfg, "port") + _moe_decode(cfg, "jax") == want, msg
    elif kind != "train":
        assert got == want, msg         # xLSTM's forward passes
    else:
        assert got - _xlstm_backward_gap(cfg) == want, msg


def _moe_decode(cfg, side):
    """The per-device dot FLOPs of a decode step's MoE layers (B = 8 rows
    over the (4, 2) mesh's 4 data groups; experts' ``ff`` split over the
    2 model shards), the router's excluded (equal on both sides).  The
    port: a data group's G = 2 tokens, C = 2·K, its three expert products
    on a shard's half of ``ff``.  JAX, as XLA's partitioner lays out the
    one group of G = 8 tokens (C = 8·K), which the data axis cannot split:
    the dispatch einsum whole on every device, the gate and up products
    with their contraction (D) split over the data axis as well, the down
    product whole over C, and the combine of a device's own 2 tokens."""
    m = cfg.moe
    E, K, D, F = m.n_experts, m.top_k, cfg.d_model, cfg.d_ff // 2
    n_data = 4
    if side == "port":
        G = B // n_data
        C = G * K
        per_layer = 3 * 2 * E * C * D * F
    else:
        G = B
        C = G * K
        per_layer = (2 * G * E * C * D                     # dispatch
                     + 2 * (2 * E * C * (D // n_data) * F)  # gate, up
                     + 2 * E * C * F * D                    # down
                     + 2 * (G // n_data) * E * C * D)       # combine
    return per_layer * cfg.n_layers


def _xlstm_backward_gap(cfg):
    """What the port's xLSTM train step differentiates less than XLA's, a
    device.  XLA transposes the mLSTM's chunk loop (a ``scan``) body by
    body; the port's autograd differentiates only what needs it: not the
    first chunk's read of the zero initial state (its ``dC``: one
    ``[C, hd] x [hd, hd]`` product, and the normalizer's matrix-vector
    product), nor the last chunk's state update, which no later chunk
    reads (the ``kvᵀ`` product's two gradients, and the normalizer's
    one).  And the normalizer's gradients that are outer products (the
    query's, at every chunk; the key's, at every chunk but the last) are
    products of contraction 1 to ``torch.utils.flop_counter``, which XLA
    emits as multiplies.  P: one chunk product of a device's heads, v: one
    matrix-vector product or outer product; per mLSTM layer and
    microbatch, −3·P − 2·v + (2·nc − 1)·v over nc chunks."""
    from repro_torch.models import xlstm
    hd = cfg.d_model // cfg.n_heads
    rows = (B // (4 * N_MB)) * (cfg.n_heads // 2)     # a device's batch × heads
    C = min(cfg.chunk, S)
    nc = S // C
    P = 2 * rows * C * hd * hd
    v = 2 * rows * C * hd
    n_mlstm = xlstm.block_types(cfg).count("mlstm")
    return -n_mlstm * N_MB * (3 * P - (2 * nc - 3) * v)


def _stats_pass_dot_flops(arch):
    """Per-device dot FLOPs of the MoE statistics pass inside the tiny
    train step (``train_loop.moe_statistics``, its own share of the
    account)."""
    from repro_torch.train import train_loop
    seen = []
    inner = train_loop.moe_statistics

    def wrapped(*a, **k):
        acct = oa.active()
        before = acct.per_device.dot_flops
        out = inner(*a, **k)
        seen.append(acct.per_device.dot_flops - before)
        return out
    train_loop.moe_statistics = wrapped
    try:
        dryrun.account_cell(_cfg(arch), ShapeSpec("t", "train", S, B), False,
                            {"n_microbatches": N_MB}, sample=False, mesh=_mesh())
    finally:
        train_loop.moe_statistics = inner
    return sum(seen)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_vs_jax(jax_walk, arch, kind):
    """The plans' bytes a shard holds on entry equal XLA's argument bytes:
    less the step counter (an int32 the port keeps as a Python int) in
    training, less the sampling key (2 uint32; the port draws from a
    ``torch.Generator``) and the cache position (an int32; a Python int)
    in decoding, where XLA also drops the parameters the step does not
    read."""
    acct, meta = port(arch, kind)
    jx = jax_walk[f"{arch}/{kind}"]
    less = {"train": 4, "prefill": 0, "decode": 8 + 4}[kind]
    if kind == "decode":
        less -= _unread_by_decode(_cfg(arch))
    assert meta["memory"]["argument_size_in_bytes"] == jx["argument_size_in_bytes"] - less, \
        _row(f"{arch}/{kind}", acct, meta, jx)


def _unread_by_decode(cfg) -> int:
    """Bytes a shard holds of the parameters a decode step does not read,
    which ``jax.jit`` drops from the executable's arguments: the audio
    family's encoder and its decoder's cross-attention K/V projections
    (the cache holds the encoder output's cross K/V)."""
    from repro_torch import sharding
    from repro_torch.models import api
    if cfg.family != "audio":
        return 0
    params = api.init_params(cfg, device=META)
    shard = sharding.param_shardings(cfg, _mesh(), params)
    unread = [(params[k], shard[k]) for k in ("enc_layers", "enc_norm")]
    unread += [(lp["xattn"][w], ls["xattn"][w]) for lp, ls in
               zip(params["dec_layers"], shard["dec_layers"]) for w in ("wk", "wv")]
    return sum(sharding.shard_bytes(t, s) for t, s in unread)


@pytest.mark.parametrize("name", list(STENCILS))
def test_stencil_collective_bytes_vs_jax(jax_walk, name):
    """The acoustic step at 64³ over (4, 2), grid axes (data, model,
    None): every slab a collective-permute of its bytes on every shard,
    as the JAX walk and ``HaloSpec`` charge it (114,688 bytes a shard an
    exchange, 753,664 at two steps an exchange)."""
    overlap, steps = STENCILS[name]
    acct, meta, _ = dryrun.account_stencil_cell(False, GRID, overlap, steps, mesh=_mesh())
    jx = jax_walk[f"stencil/{name}"]
    spec = meta["spec"]
    halo = spec.window_collective_bytes(steps, 4) if steps > 1 else spec.exchange_bytes(4)
    got = acct.per_device.collective_bytes
    assert got == jx["total_collective_bytes"] == halo, (got, jx, halo)
    assert acct.per_device.coll_counts["collective-permute"] == \
        jx["collective_counts"]["collective-permute"]
    assert {"overlap": 114688, "no-overlap": 114688, "time-skewed": 753664}[name] == got


def main():
    procs = _start_jax()
    jx = _collect(procs)
    for arch in ARCHS:
        for kind in KINDS:
            acct, meta = port(arch, kind)
            print(_row(f"{arch}/{kind}", acct, meta, jx[f"{arch}/{kind}"]))
    for name, (overlap, steps) in STENCILS.items():
        acct, meta, _ = dryrun.account_stencil_cell(False, GRID, overlap, steps,
                                                    mesh=_mesh())
        print(_row(f"stencil/{name}", acct, meta, jx[f"stencil/{name}"]))


if __name__ == "__main__":
    main()
