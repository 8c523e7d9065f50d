#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--quick] [--json PATH]

Phases, each of which exits non-zero when it fails:

1. environment — the card's name and power limit (``nvidia-smi``) and its
   compute capability, which must be 9.x (Hopper);
2. build — every kernel of the main paths (K1 fused step: K4 gmem's
   body in place, K2 2.5D
   streaming, K3 temporal blocking at k=2 and k=3, K5 semi-stencil, and
   the per-application kernels of ``st.map``: K4 gmem/f4/smem, K2's and
   K5's builds with a destination, for ``star3d4r`` and acoustic ISO, and
   for a Jacobi kernel that reads its output off-center), built from
   ``src`` with one ``nvcc`` per source, all started together;
3. kernels — each kernel against its plain PyTorch version on the card,
   after one launch (K3: k=2 and k=3, both reading buffers left intact),
   at a block-multiple shape (64³), a ragged one (61×70×133) and the
   main-path shape (512³, K3 at k=2 only); time per step of kernel and
   plain version at 512³ (CUDA events; K3's launch time divided by k),
   and for ``star3d4r`` of the one library call that computes the same
   update (``conv3d`` in f32 with the star as a dense 9³ weight); then
   each per-application kernel against its plain version after one
   application at the same shapes, at a sub-region whose z-start is not a
   multiple of 4, and for the Jacobi kernel (outputs into a destination
   buffer), with its time per application at 512³;
4. main path — at 512³ f32 interior through ``st.launch(backend=
   st.hopper(...))``: templates gmem (K1), shift (K2), shift with
   ``time_block=2`` (K3) and semi (K5); ``star3d4r`` 100 steps, acoustic
   ISO 100 steps with ``fuse_steps=10`` and source injection in
   ``between``; the launch counters must show exactly the path's kernel
   (K3: 50 launches, the others 100), the fields must be finite and
   match ``st.torch()`` on the card over the same steps;
5. absorbing boundary — acoustic ISO as in 4 at 64³, where the wave
   enters the PML within the 100 steps, against ``st.torch()``, plus K3
   with ``fuse_steps=7`` (3 K3 launches and one K2 remainder step a
   window);
6. per-application main path — at 512³ f32 under templates gmem, f4, smem
   (K4), shift (K4 streaming) and semi (K5): ``star3d4r`` as 100 ``st.map``
   applications with the ``(u.data, v.data)`` swap, acoustic ISO through
   ``acoustic.run(iters=100, pml_width=10)`` with the source injected every
   step; exactly 100 launches of the path's kernel and no other, fields
   within 2e-5 of their max of the same loop under ``st.torch()``;
7. regions and Listing 1 — one ``star3d4r`` application at 512³ as the
   seven regions of ``regions.seven_region(shape, 10)`` under gmem and f4
   against one whole-interior ``st.map`` under the same template, and that
   against one under ``st.torch()``; the paper's Listing 1 (2D
   ``star2d4r``, 50 ``st.map`` steps at 256² under ``st.cuda(
   computeCapability="9.0", threadsPerBlock=(8, 128), template="gmem")``)
   against ``st.torch()`` within 1e-5 of the field's max.

It prints the kernels line ``{"kernels": [...]}`` and then, last,
``{"ok": true, "device": {...}}``.  ``--quick`` runs phases 1–3 at the two
small shapes only and prints no result line.  Phases 4 and 5 read the
launch counts of the fused path, 6 and 7 those of ``st.map``: each sets
the counts to 0 just before its run and reads them just after.  The script imports neither
JAX nor the JAX package, and needs nothing outside the checkout.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SMALL_SHAPES = ((64, 64, 64), (61, 70, 133))
MAIN_SHAPE = (512, 512, 512)
PML_SHAPE = (64, 64, 64)
STEPS = 100
ACOUSTIC_FUSE = 10
# kernel wrapper -> (template, time_block) of its main path
KERNELS = {"fused_step": ("gmem", 1), "stream_step": ("shift", 1),
           "temporal_step": ("shift", 2), "semi_step": ("semi", 1)}
REPLACES = {
    "fused_step": "src/repro/kernels/stencil/codegen.py:682",
    "stream_step": "src/repro/kernels/stencil/codegen.py:367",
    "temporal_step": "src/repro/kernels/stencil/codegen.py:699",
    "semi_step": "src/repro/kernels/stencil/codegen.py:319",
}
# per-application kernels of st.map: entry -> (kernel wrapper, template)
MAP_KERNELS = {"map_step.gmem": ("map_step", "gmem"),
               "map_step.f4": ("map_step", "f4"),
               "map_step.smem": ("map_step", "smem"),
               "stream_step.map": ("stream_step", "shift"),
               "semi_step.map": ("semi_step", "semi")}
REPLACES.update({
    "map_step.gmem": "src/repro/kernels/stencil/codegen.py:203",
    "map_step.f4": "src/repro/kernels/stencil/codegen.py:203",
    "map_step.smem": "src/repro/kernels/stencil/codegen.py:203",
    "stream_step.map": "src/repro/kernels/stencil/codegen.py:429",
    "semi_step.map": "src/repro/kernels/stencil/codegen.py:319",
})
# a sub-region of the ragged shape whose z-start (and origin) is not a
# multiple of 4: f4 loads from below its first cell
SUB_REGION = ((5, 50), (3, 61), (10, 127))
PML_WIDTH = 10
LISTING1_SHAPE, LISTING1_STEPS = (256, 256), 50
# K3 is also checked at an odd depth (the other leapfrog parity)
TEMPORAL_SMALL_DEPTHS = (2, 3)
# device memory rate (B/s) and f32 rate outside the tensor cores (FLOP/s)
# of the card the bounds were derived for, from NVIDIA's data sheet (H100
# SXM); another card gets no bound
CARD_RATES = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12)}
# hopper vs st.torch() after 100 steps, relative to the field's max: the
# leapfrog update carries per-step rounding differences (FMA contraction,
# summation order) forward; an H100 reads 4e-7 (star) and 2e-6 (acoustic)
END_TO_END_RTOL = 2e-5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def max_diff(torch, key, got, ref):
    """(max |got - ref| over the grids of ``ref``, max |ref|); fails on a
    non-finite field of ``got`` or a difference over the limit."""
    diff = 0.0
    for g, ref_g in ref.items():
        a = got[g].data
        if not bool(torch.isfinite(a).all()):
            fail(f"{key}: non-finite field '{g}' after {STEPS} steps")
        diff = max(diff, float((a - ref_g.data).abs().max()))
    scale = max(float(r.data.abs().max()) for r in ref.values())
    if diff > END_TO_END_RTOL * max(scale, 1e-3):
        fail(f"{key}: max |hopper - torch| = {diff} after {STEPS} steps "
             f"(field max {scale}, limit {END_TO_END_RTOL} of it)")
    return diff, scale


def star_conv(torch, w, codegen, plain, ref):
    """``star3d4r`` as one library call: ``conv3d`` (a correlation, as
    ``u.at`` reads) of the halo'd ``u`` with the star's taps as a dense
    (2h+1)³ weight, zero off the star, in f32 (TF32 off).  The weight is
    the plain version's response to a unit impulse, flipped.  Checked
    against the plain version's output in ``ref``; returns (ms, max abs
    err)."""
    F = torch.nn.functional
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    h = w.halo
    n = 2 * h + 1
    probe = w.plan(codegen, (n,) * 3, "gmem")
    imp = {g: torch.zeros((n + 2 * h,) * 3, device="cuda")
           for g in w.kernel.ir.grid_params}
    imp["u"][(2 * h,) * 3] = 1.0
    imp = probe.to_padded(imp)
    plain(probe, imp, {})
    weight = imp["v"][h:-h, h:-h, h:-h].flip(0, 1, 2).contiguous()[None, None]
    x = ref["u"][None, None]
    out = F.conv3d(x, weight)[0, 0]
    want = ref["v"][h:-h, h:-h, h:-h]
    err = float((out - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    if err > 2e-5 * scale:
        fail(f"conv3d[star3d4r]: max |conv3d - plain| = {err} > 2e-5 * {scale}")
    del out
    return time_ms(torch, lambda: F.conv3d(x, weight), 5, 2), err


class Workload:
    """One main-path kernel (or ``kernel``, given): its IR, halos, fields
    made from a seed."""

    def __init__(self, name, mods, kernel=None):
        self.name = name
        st, suite, acoustic = mods["st"], mods["suite"], mods["acoustic"]
        if kernel is not None:
            self.kernel, self.swap, self.scalars = kernel, None, {}
        elif name == "star3d4r":
            self.kernel = suite.get_kernel("star3d4r")
            self.swap = ("v", "u")
            self.scalars = {}
        else:
            self.kernel = acoustic.acoustic_iso_kernel
            self.swap = ("p0", "p1")
            self.scalars = {"dt": 0.30000001192092896}      # f32(0.3)
        self.st = st
        self.halo = self.kernel.info.order

    def plan(self, codegen, shape, template, time_block=1):
        halos = {g: (self.halo,) * 3 for g in self.kernel.ir.grid_params}
        return codegen.plan_cuda(
            self.kernel.ir, halos, shape,
            self.st.hopper(template=template, time_block=time_block),
            swap=self.swap)

    def map_plan(self, codegen, shape, template, region=None):
        halos = {g: (self.halo,) * 3 for g in self.kernel.ir.grid_params}
        return codegen.lower_hopper(self.kernel.ir, halos, shape, region,
                                    self.st.hopper(template=template))

    def arrays(self, torch, shape, seed):
        """Random halo'd fields on the card (torch generator, seeded);
        acoustic coefficients in their physical ranges."""
        gen = torch.Generator(device="cuda").manual_seed(seed)
        full = tuple(s + 2 * self.halo for s in shape)
        out = {}
        for g in self.kernel.ir.grid_params:
            if g == "vp2":
                out[g] = 0.5 + 1.5 * torch.rand(full, generator=gen, device="cuda")
            elif g == "damp":
                out[g] = 0.2 * torch.rand(full, generator=gen, device="cuda")
            else:
                out[g] = torch.randn(full, generator=gen, device="cuda")
        return out


def extra_kernels(st):
    """A Jacobi sweep that reads its output grid off-center (its
    per-application kernels write into a destination buffer), and the
    paper's Listing 1 stencil (``examples/quickstart.py``)."""
    @st.kernel
    def jacobi3d(u: st.grid, f: st.grid):
        u.at(0, 0, 0).set(0.16666667 * (u.at(-1, 0, 0) + u.at(1, 0, 0)
                                        + u.at(0, -1, 0) + u.at(0, 1, 0)
                                        + u.at(0, 0, -1) + u.at(0, 0, 1))
                          - 0.5 * f.at(0, 0, 0))

    @st.kernel
    def kernel_star2d4r(u: st.grid, v: st.grid):
        v.at(0, 0).set(0.25005 * u.at(0, 0)
                       + 0.11111 * (u.at(-4, 0) + u.at(4, 0))
                       + 0.06251 * (u.at(-3, 0) + u.at(3, 0))
                       + 0.06255 * (u.at(-2, 0) + u.at(2, 0))
                       + 0.06245 * (u.at(-1, 0) + u.at(1, 0))
                       + 0.06248 * (u.at(0, -1) + u.at(0, 1))
                       + 0.06243 * (u.at(0, -2) + u.at(0, 2))
                       + 0.06253 * (u.at(0, -3) + u.at(0, 3))
                       - 0.22220 * (u.at(0, -4) + u.at(0, 4)))
    return jacobi3d, kernel_star2d4r


def bound_of(rates, nbytes: float, nflop: float):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over the f32 rate; (None, None)
    without rates."""
    if rates is None:
        return None, None
    t_bytes = nbytes / rates[0] * 1e3
    t_ops = nflop / rates[1] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def one_map(torch, key, kern, plain, plan, arrays, scalars):
    """One application of per-application kernel ``kern`` and of its plain
    version on copies of the same grids; returns (max abs err, timing
    closures).  Fails on a non-finite output, a difference over the limit
    or, when the plan writes to destinations, a write into a grid."""
    bufs = {g: arrays[g] for g in plan.opnd_grids}
    ref = {g: t.clone() for g, t in bufs.items()}
    dst, rdst = plan.make_dst(bufs), plan.make_dst(ref)
    kern(plan, bufs, scalars, dst)
    plain(plan, ref, scalars, rdst)
    torch.cuda.synchronize()
    err = 0.0
    for g in plan.out_grids:
        # in place the whole tensor: cells outside the region must keep
        # their values, as the plain version leaves them
        a, b = (bufs[g], ref[g]) if dst is None else (dst[g], rdst[g])
        if not bool(torch.isfinite(a).all()):
            fail(f"{key}: non-finite output '{g}'")
        e = float((a - b).abs().max())
        scale = max(1.0, float(b.abs().max()))
        # f32 sums of the taps in another order, with FMA contraction
        if e > 2e-5 * scale:
            fail(f"{key}: max |kernel - plain| = {e} > 2e-5 * {scale}")
        err = max(err, e)
    if dst is not None and not all(torch.equal(bufs[g], ref[g]) for g in bufs):
        fail(f"{key}: the kernel wrote a grid it should leave to the copy")
    return (err, lambda: kern(plan, bufs, scalars, dst),
            lambda: plain(plan, ref, scalars, rdst))


def time_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def one_launch(torch, kname, kern, plain, plan, arrays, scalars):
    """One launch of kernel ``kern`` and of its plain version on the same
    layout buffers; returns (kernel result, plain result, timing closures),
    the results keyed by the grids they write.  K3 writes into spares and
    must leave the buffers it reads as they were."""
    padded = plan.to_padded(arrays)
    if kname == "temporal_step":
        before = {g: t.clone() for g, t in padded.items()}
        spares, ref = plan.make_spares(padded), plan.make_spares(padded)
        kern(plan, padded, spares, scalars)
        plain(plan, padded, ref, scalars)
        torch.cuda.synchronize()
        for g, t in padded.items():
            if not bool(torch.equal(t, before[g])):
                fail(f"{kname}: the kernel wrote the buffer of '{g}' it reads")
        del before
        return (spares, ref,
                lambda: kern(plan, padded, spares, scalars),
                lambda: plain(plan, padded, ref, scalars))
    ref = {g: t.clone() for g, t in padded.items()}
    kern(plan, padded, scalars)
    plain(plan, ref, scalars)
    torch.cuda.synchronize()
    return (padded, ref, lambda: kern(plan, padded, scalars),
            lambda: plain(plan, ref, scalars))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="phases 1-3 at the small shapes only, no result line")
    ap.add_argument("--json", help="also write every number to this file")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.core import acoustic, regions, suite
        from repro_torch.core import dsl as st
        from repro_torch.kernels.stencil import _build, codegen
        from repro_torch.kernels.stencil.fused_step import (fused_step,
                                                           fused_step_plain)
        from repro_torch.kernels.stencil.map_step import (map_step,
                                                         map_step_plain)
        from repro_torch.kernels.stencil.semi_step import (semi_step,
                                                          semi_step_plain)
        from repro_torch.kernels.stencil.stream_step import (stream_step,
                                                            stream_step_plain)
        from repro_torch.kernels.stencil.temporal_step import (
            temporal_step, temporal_step_plain)
    except ImportError as e:
        fail(f"cannot import the port from {ROOT / 'src'}: {e}")
    wrappers = {"fused_step": (fused_step, fused_step_plain),
                "stream_step": (stream_step, stream_step_plain),
                "temporal_step": (temporal_step, temporal_step_plain),
                "semi_step": (semi_step, semi_step_plain),
                "map_step": (map_step, map_step_plain)}

    def reset_counts():
        for kern, _ in wrappers.values():
            kern.launches = 0

    def counts():
        return {kname: kern.launches for kname, (kern, _) in wrappers.items()}

    record = {"phases": {}}

    # -- 1. environment ------------------------------------------------------
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        fail(f"nvidia-smi: {e}")
    say(smi)
    name = torch.cuda.get_device_name(0)
    cc = torch.cuda.get_device_capability(0)
    say(f"device: {name}, compute capability {cc[0]}.{cc[1]}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if cc[0] != 9:
        fail(f"compute capability {cc} is not 9.x: the kernels target sm_90a")
    rates = CARD_RATES.get(name)
    if rates is None:
        say(f"bounds: no data-sheet rates for {name!r}; bound_ms is null")
    else:
        say(f"bounds: {rates[0] / 1e12} TB/s, {rates[1] / 1e12} TFLOP/s f32")
    record["device"] = {"name": name, "nvidia_smi": smi,
                        "capability": list(cc)}

    mods = {"st": st, "suite": suite, "acoustic": acoustic}
    workloads = [Workload("star3d4r", mods), Workload("acoustic_iso", mods)]
    jacobi3d, listing1_kernel = extra_kernels(st)
    jacobi = Workload("jacobi3d", mods, kernel=jacobi3d)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    sources = [w.plan(codegen, MAIN_SHAPE, t, k).source()
               for w in workloads for t, k in KERNELS.values()]
    sources += [w.plan(codegen, MAIN_SHAPE, KERNELS["temporal_step"][0],
                       k).source()
                for w in workloads for k in TEMPORAL_SMALL_DEPTHS]
    # a map plan's source does not depend on the shape or the region
    sources += [w.map_plan(codegen, SMALL_SHAPES[0], t).source()
                for w in workloads + [jacobi] for _, t in MAP_KERNELS.values()]
    sources += [codegen.lower_hopper(
        listing1_kernel.ir, {"u": (4, 4), "v": (4, 4)}, LISTING1_SHAPE, None,
        st.cuda(computeCapability="9.0", threadsPerBlock=(8, 128),
                template="gmem")).source()]
    try:
        _build.build_many(sources)
    except RuntimeError as e:
        fail(f"build: {e}")
    build_s = time.perf_counter() - t0
    sources = list(dict.fromkeys(sources))
    say(f"build: {len(sources)} kernels in {build_s:.1f} s")
    for src in sources:
        for line in _build.ptxas_log(src).splitlines():
            if "registers" in line or "spill" in line:
                say(f"  ptxas: {line.strip()}")
    record["phases"]["build_s"] = build_s

    # -- 3. kernels vs plain versions ----------------------------------------
    shapes = SMALL_SHAPES if args.quick else SMALL_SHAPES + (MAIN_SHAPE,)
    entries = {}
    library = {}        # workload -> ms of its one library call, or None
    for w in workloads:
        for kname, (template, k_main) in KERNELS.items():
            kern, plain = wrappers[kname]
            key = f"{kname}[{w.name}]"
            worst = 0.0
            for shape in shapes:
                depths = ((k_main,) if kname != "temporal_step"
                          or shape == MAIN_SHAPE else TEMPORAL_SMALL_DEPTHS)
                for k in depths:
                    plan = w.plan(codegen, shape, template, k)
                    got, ref, run_kern, run_plain = one_launch(
                        torch, kname, kern, plain, plan,
                        w.arrays(torch, shape, seed=1), w.scalars)
                    err = 0.0
                    for g in plan.step_out_grids:
                        a, b = got[g], ref[g]
                        if not bool(torch.isfinite(a).all()):
                            fail(f"{key} k={k} at {shape}: non-finite output")
                        err = max(err, float((a - b).abs().max()))
                        scale = max(1.0, float(b.abs().max()))
                        # f32 sums of 25 taps in another order, with FMA
                        # contraction on the card: a few ulp of the magnitude
                        if err > 2e-5 * scale:
                            fail(f"{key} k={k} at {shape}: max |kernel - "
                                 f"plain| = {err} > 2e-5 * {scale}")
                    worst = max(worst, err)
                    say(f"kernel {key} k={k} {shape}: max abs err {err:.3g}")
                    if shape == MAIN_SHAPE:
                        ms = time_ms(torch, run_kern, 50, 10) / k
                        plain_ms = time_ms(
                            torch, run_plain,
                            5 if kname == "fused_step" else 1) / k
                        if w.name not in library:
                            library[w.name] = None
                            if w.name == "star3d4r":
                                lib_ms, lib_err = star_conv(torch, w, codegen,
                                                            fused_step_plain,
                                                            ref)
                                library[w.name] = lib_ms
                                say(f"library conv3d[star3d4r] {shape}: "
                                    f"{lib_ms:.4f} ms, max abs err vs plain "
                                    f"{lib_err:.3g}")
                        info = w.kernel.info
                        n = np.prod(shape, dtype=np.float64)
                        # compulsory traffic: each input read once and each
                        # buffer the launch writes written once, per k steps
                        nbytes = 4 * n * (len(info.input_grids)
                                          + len(plan.step_out_grids)) / k
                        bound, bound_by = bound_of(
                            rates, nbytes, info.flops_per_point * n)
                        lib = (library[w.name] if kname != "temporal_step"
                               else None)   # no one call does k steps
                        entries[key] = {
                            "name": key, "route": "cuda",
                            "source": "src/repro_torch/kernels/stencil/csrc/"
                                      + codegen.KERNEL_FILES[plan.kind],
                            "replaces": REPLACES[kname], "launches": None,
                            "max_abs_err": None, "ms": ms,
                            "plain_ms": plain_ms, "bound_ms": bound,
                            "bound_by": bound_by, "library_ms": lib,
                            "time_block": k,
                            "modeled_bytes_per_step": plan.hbm_bytes_per_step()}
                        say(f"time {key} {shape}: {ms:.4f} ms/step "
                            f"(plain {plain_ms:.2f} ms, bound {bound} ms, "
                            f"library {lib} ms)")
                    del plan, got, ref, run_kern, run_plain
                    torch.cuda.empty_cache()
            if key in entries:
                entries[key]["max_abs_err"] = worst

    # the per-application kernels: the workloads at every shape and at a
    # sub-region of the ragged one; the Jacobi kernel (outputs into a
    # destination) at the ragged shape and the sub-region
    for w in workloads + [jacobi]:
        for ename, (wname, template) in MAP_KERNELS.items():
            kern, plain = wrappers[wname]
            key = f"{ename}[{w.name}]"
            cases = [(shape, None) for shape in shapes if w is not jacobi]
            cases += [(SMALL_SHAPES[1], None)] if w is jacobi else []
            cases += [(SMALL_SHAPES[1], SUB_REGION)]
            worst = 0.0
            for shape, region in cases:
                plan = w.map_plan(codegen, shape, template, region)
                if plan.in_place == (w is jacobi):
                    fail(f"{key}: in_place is {plan.in_place}")
                err, run_kern, run_plain = one_map(
                    torch, f"{key} at {shape} region {region}", kern, plain,
                    plan, w.arrays(torch, shape, seed=2), w.scalars)
                worst = max(worst, err)
                say(f"kernel {key} {shape} region {region}: max abs err "
                    f"{err:.3g}")
                if shape == MAIN_SHAPE:
                    ms = time_ms(torch, run_kern, 50, 10)
                    plain_ms = time_ms(torch, run_plain, 1)
                    info = w.kernel.info
                    n = np.prod(shape, dtype=np.float64)
                    bound, bound_by = bound_of(
                        rates, 4 * n * (len(info.input_grids)
                                        + len(info.output_grids)),
                        info.flops_per_point * n)
                    entries[key] = {
                        "name": key, "route": "cuda",
                        "source": "src/repro_torch/kernels/stencil/csrc/"
                                  + codegen.KERNEL_FILES[plan.kind],
                        "replaces": REPLACES[ename], "launches": None,
                        "max_abs_err": None, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": bound_by,
                        "library_ms": library.get(w.name),
                        "template": template,
                        "modeled_bytes_per_step": plan.hbm_bytes_per_step()}
                    say(f"time {key} {shape}: {ms:.4f} ms/application "
                        f"(plain {plain_ms:.2f} ms, bound {bound} ms, "
                        f"library {library.get(w.name)} ms)")
                del plan, run_kern, run_plain
                torch.cuda.empty_cache()
            if key in entries:
                entries[key]["max_abs_err"] = worst
    if args.quick:
        say("quick: phases 1-3 passed")
        return 0

    # -- 4. main path ----------------------------------------------------------
    main_rows = []

    def star_run(backend, grids):
        k = suite.get_kernel("star3d4r")

        @st.target
        def run(u, v):
            return st.timeloop(STEPS, swap=("v", "u"))(k)(u, v)
        return st.launch(backend=backend)(run)(grids["u"], grids["v"]).value

    def acoustic_run(backend, fields, fuse=ACOUSTIC_FUSE):
        p0, p1, vp2, damp, dt = fields
        acoustic.inject_source(p1, 0)

        def between(t, grids):
            acoustic.inject_source(grids["p1"], t)
        return st.launch(backend=backend, fuse_steps=fuse)(
            acoustic.acoustic_target_fused)(p0, p1, vp2, damp, dt, STEPS,
                                            between=between).value

    def hopper(kname):
        template, k = KERNELS[kname]
        return st.hopper(template=template, time_block=k)

    for w in workloads:
        if w.name == "star3d4r":
            init = suite.make_grids("star3d4r", MAIN_SHAPE, seed=0)
            fresh = lambda: {g: x.copy() for g, x in init.items()}  # noqa: E731
            run = star_run
        else:
            init = acoustic.make_fields(MAIN_SHAPE, pml_width=10)
            fresh = lambda: tuple(x.copy() for x in init[:4]) + (init[4],)  # noqa: E731
            run = acoustic_run
        ref_fields = fresh()
        t0 = time.perf_counter()
        run(st.torch(), ref_fields)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        ref = (ref_fields if isinstance(ref_fields, dict)
               else dict(zip(("p0", "p1"), ref_fields[:2])))
        for kname, (template, k) in KERNELS.items():
            key = f"{kname}[{w.name}]"
            fields = fresh()
            reset_counts()
            res = run(hopper(kname), fields)
            seen = counts()
            got = (fields if isinstance(fields, dict)
                   else dict(zip(("p0", "p1"), fields[:2])))
            if seen[kname] != STEPS // k or sum(seen.values()) != STEPS // k:
                fail(f"{key}: launch counts {seen}, expected {STEPS // k} "
                     f"of {kname} and no other")
            entries[key]["launches"] = seen[kname]
            diff, scale = max_diff(torch, key, got, ref)
            n = float(np.prod(MAIN_SHAPE))
            steps_s = STEPS / res.seconds
            nbytes = 4 * n * (len(w.kernel.info.input_grids)
                              + len(w.kernel.info.output_grids))
            row = {"path": key, "template": template, "time_block": k,
                   "steps": STEPS, "fuse_steps": res.fuse_steps,
                   "seconds": res.seconds, "steps_per_s": steps_s,
                   "gpoints_per_s": steps_s * n / 1e9,
                   "effective_gb_per_s": steps_s * nbytes / 1e9,
                   "max_abs_diff_vs_torch": diff, "field_max": scale,
                   "torch_seconds": ref_s}
            main_rows.append(row)
            say(f"main path {key}: {STEPS} steps in {res.seconds:.3f} s = "
                f"{steps_s:.1f} steps/s, {row['gpoints_per_s']:.2f} Gpoint/s, "
                f"{row['effective_gb_per_s']:.0f} GB/s effective; "
                f"max |diff| vs st.torch() {diff:.3g} (field max {scale:.3g}); "
                f"st.torch() took {ref_s:.1f} s")
            del fields, got
            torch.cuda.empty_cache()
        del ref, ref_fields, init
        torch.cuda.empty_cache()

    # -- 5. absorbing boundary -------------------------------------------------
    init = acoustic.make_fields(PML_SHAPE, pml_width=10)
    fresh = lambda: tuple(x.copy() for x in init[:4]) + (init[4],)  # noqa: E731
    refs = {}           # fusion window -> st.torch() fields (the source is
    for fuse in (ACOUSTIC_FUSE, 7):     # injected once a window)
        ref_fields = fresh()
        acoustic_run(st.torch(), ref_fields, fuse)
        refs[fuse] = dict(zip(("p0", "p1"), ref_fields[:2]))
    pml = init[3].data > 0              # damp's halo is 0: the PML's points
    share = min(max(float(r.data[pml].abs().max()) for r in ref.values())
                / max(float(r.data.abs().max()) for r in ref.values())
                for ref in refs.values())
    if share < 1e-2:
        fail(f"acoustic at {PML_SHAPE}: the wave has not reached the PML "
             f"(max there {share} of the field's max)")
    pml_rows = []
    # (label, kernel path, fusion window, expected launch counts): with
    # fuse_steps=7 and k=2 a window is 3 K3 launches and one K2 step
    pml_runs = [(kname, kname, ACOUSTIC_FUSE, {kname: STEPS // KERNELS[kname][1]})
                for kname in KERNELS]
    pml_runs.append(("temporal_step fuse 7", "temporal_step", 7,
                     {"temporal_step": (STEPS // 7) * 3 + (STEPS % 7) // 2,
                      "stream_step": (STEPS // 7) + (STEPS % 7) % 2}))
    for label, kname, fuse, want in pml_runs:
        key = f"acoustic_iso {PML_SHAPE} {label}"
        fields = fresh()
        reset_counts()
        res = acoustic_run(hopper(kname), fields, fuse)
        seen = counts()
        if {g: c for g, c in seen.items() if c} != want:
            fail(f"{key}: launch counts {seen}, expected {want}")
        if res.windows != -(-STEPS // fuse):
            fail(f"{key}: {res.windows} windows")
        diff, scale = max_diff(torch, key, dict(zip(("p0", "p1"), fields[:2])),
                               refs[fuse])
        pml_rows.append({"path": key, "fuse_steps": fuse, "launches": seen,
                         "max_abs_diff_vs_torch": diff, "field_max": scale,
                         "pml_share_of_max": share})
        say(f"absorbing boundary {key}: max |diff| vs st.torch() {diff:.3g} "
            f"(field max {scale:.3g}; in the PML {share:.2f} of it)")
    record["absorbing_boundary"] = pml_rows

    # -- 6. per-application main path --------------------------------------------
    def star_map(backend):
        grids = suite.make_grids("star3d4r", MAIN_SHAPE, seed=0)
        k = suite.get_kernel("star3d4r")

        @st.target
        def run(u, v):
            for _ in range(STEPS):
                st.map(e=u.shape)(k)(u, v)
                (u.data, v.data) = (v.data, u.data)
        t0 = time.perf_counter()
        st.launch(backend=backend)(run)(grids["u"], grids["v"])
        torch.cuda.synchronize()
        return time.perf_counter() - t0, grids

    def acoustic_map(backend):
        # the wall time of the step loop, source injections included as
        # in the fused run's ``between``; the fields are made before it
        p1, prof = acoustic.run(shape=MAIN_SHAPE, iters=STEPS,
                                pml_width=PML_WIDTH, backend=backend)
        torch.cuda.synchronize()
        return prof["loop"], {"p1": p1}

    map_rows = []
    n = float(np.prod(MAIN_SHAPE))
    for w, run in zip(workloads, (star_map, acoustic_map)):
        ref_s, ref = run(st.torch())
        nbytes = 4 * n * (len(w.kernel.info.input_grids)
                          + len(w.kernel.info.output_grids))
        for ename, (wname, template) in MAP_KERNELS.items():
            key = f"{ename}[{w.name}]"
            reset_counts()
            seconds, got = run(st.hopper(template=template))
            seen = counts()
            if seen[wname] != STEPS or sum(seen.values()) != STEPS:
                fail(f"st.map {key}: launch counts {seen}, expected {STEPS} "
                     f"of {wname} and no other")
            entries[key]["launches"] = seen[wname]
            diff, scale = max_diff(torch, f"st.map {key}", got, ref)
            steps_s = STEPS / seconds
            row = {"path": f"st.map {key}", "template": template,
                   "steps": STEPS, "seconds": seconds, "steps_per_s": steps_s,
                   "gpoints_per_s": steps_s * n / 1e9,
                   "effective_gb_per_s": steps_s * nbytes / 1e9,
                   "max_abs_diff_vs_torch": diff, "field_max": scale,
                   "torch_seconds": ref_s}
            map_rows.append(row)
            say(f"per-application path {key}: {STEPS} st.map in {seconds:.3f}"
                f" s = {steps_s:.1f} steps/s, {row['gpoints_per_s']:.2f} "
                f"Gpoint/s, {row['effective_gb_per_s']:.0f} GB/s effective; "
                f"max |diff| vs st.torch() {diff:.3g} (field max {scale:.3g});"
                f" st.torch() took {ref_s:.1f} s")
            del got
            torch.cuda.empty_cache()
        del ref
        torch.cuda.empty_cache()
    record["map_path"] = map_rows

    # -- 7. regions and Listing 1 ------------------------------------------------
    k = suite.get_kernel("star3d4r")
    init = suite.make_grids("star3d4r", MAIN_SHAPE, seed=3)
    boxes = regions.seven_region(MAIN_SHAPE, PML_WIDTH)
    region_rows = []

    def whole_map(be):
        whole = {g: x.copy() for g, x in init.items()}
        st.launch(backend=be)(lambda u, v: st.map(e=u.shape)(k)(u, v))(
            whole["u"], whole["v"])
        return whole
    want = whole_map(st.torch())
    for template in ("gmem", "f4"):
        be = st.hopper(template=template)
        whole = whole_map(be)
        diff_torch, _ = max_diff(torch, f"whole-interior {template}", whole,
                                 want)
        parts = {g: x.copy() for g, x in init.items()}

        def seven(u, v):
            for r in boxes:
                st.map(begin=[b for b, _ in r], end=[e for _, e in r])(k)(u, v)
        reset_counts()
        st.launch(backend=be)(seven)(parts["u"], parts["v"])
        seen = counts()
        if seen["map_step"] != len(boxes) or sum(seen.values()) != len(boxes):
            fail(f"seven regions {template}: launch counts {seen}")
        diff, scale = max_diff(torch, f"seven regions {template}", parts, whole)
        region_rows.append({"template": template, "regions": len(boxes),
                            "max_abs_diff_vs_whole": diff,
                            "whole_max_abs_diff_vs_torch": diff_torch})
        say(f"seven regions {template} at {MAIN_SHAPE}: max |diff| vs one "
            f"whole-interior st.map {diff:.3g} (field max {scale:.3g}), "
            f"which is {diff_torch:.3g} from st.torch()")
        del whole, parts
    del init, want
    torch.cuda.empty_cache()

    def listing1(u, v, iters):
        for _ in range(iters):
            st.map(e=u.shape)(listing1_kernel)(u, v)
            (u.data, v.data) = (v.data, u.data)

    def listing1_grids():
        return (st.grid(dtype=st.f32, shape=LISTING1_SHAPE, order=4).randomize(0),
                st.grid(dtype=st.f32, shape=LISTING1_SHAPE, order=4))
    u, v = listing1_grids()
    st.launch(backend=st.torch())(listing1)(u, v, LISTING1_STEPS)
    want = u.interior.clone()
    u, v = listing1_grids()
    reset_counts()
    st.launch(backend=st.cuda(computeCapability="9.0", threadsPerBlock=(8, 128),
                              template="gmem"))(listing1)(u, v, LISTING1_STEPS)
    seen = counts()
    if seen["map_step"] != LISTING1_STEPS or sum(seen.values()) != LISTING1_STEPS:
        fail(f"Listing 1: launch counts {seen}")
    err = float((u.interior - want).abs().max())
    scale = max(1.0, float(want.abs().max()))
    # the stencil amplifies oscillatory modes: the quickstart's own limit
    if not err / scale < 1e-5:
        fail(f"Listing 1: max |hopper - torch| = {err} ({err / scale} of "
             f"{scale})")
    say(f"Listing 1 at {LISTING1_SHAPE}, {LISTING1_STEPS} steps: max |hopper "
        f"- torch| {err:.3g} (relative {err / scale:.3g})")
    record["regions"] = region_rows
    record["listing1"] = {"max_abs_diff": err, "relative": err / scale}

    kernels = [entries[f"{k}[{w.name}]"] for w in workloads
               for k in list(KERNELS) + list(MAP_KERNELS)]
    record["kernels"], record["main_path"] = kernels, main_rows
    if args.json:
        path = pathlib.Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(record, indent=1))
    line = {"kernels": [{k: e[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms")} for e in kernels]}
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
