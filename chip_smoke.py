#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--quick] [--json PATH]

Phases, each of which exits non-zero when it fails:

1. environment — the card's name and power limit (``nvidia-smi``) and its
   compute capability, which must be 9.x (Hopper);
2. build — every kernel of the main path, built from ``src`` with one
   ``nvcc`` per source, all started together;
3. kernels — K1 (fused step, template gmem) and K2 (2.5D streaming,
   template shift) for ``star3d4r`` and acoustic ISO, one step of each
   against its plain PyTorch version on the card, at a block-multiple
   shape (64³), a ragged one (61×70×133) and the main-path shape (512³);
   time per step of kernel and plain version at 512³ (CUDA events), and
   for ``star3d4r`` of the one library call that computes the same
   update (``conv3d`` in f32 with the star as a dense 9³ weight);
4. main path — at 512³ f32 interior through
   ``st.launch(backend=st.hopper(template=...))`` for both templates:
   ``star3d4r`` 100 steps, acoustic ISO 100 steps with ``fuse_steps=10``
   and source injection in ``between``; the launch counters must equal
   the step count, the fields must be finite and match ``st.torch()`` on
   the card over the same steps;
5. absorbing boundary — acoustic ISO as in 4 at 64³, where the wave
   enters the PML within the 100 steps, against ``st.torch()``.

It prints the kernels line ``{"kernels": [...]}`` and then, last,
``{"ok": true, "device": {...}}``.  ``--quick`` runs phases 1–3 at the two
small shapes only and prints no result line.  The script imports neither
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
TEMPLATES = {"fused_step": "gmem", "stream_step": "shift"}
REPLACES = {
    "fused_step": "src/repro/kernels/stencil/codegen.py:682",
    "stream_step": "src/repro/kernels/stencil/codegen.py:367",
}
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
    """One main-path kernel: its IR, halos, fields made from a seed."""

    def __init__(self, name, mods):
        self.name = name
        st, suite, acoustic = mods["st"], mods["suite"], mods["acoustic"]
        if name == "star3d4r":
            self.kernel = suite.get_kernel("star3d4r")
            self.swap = ("v", "u")
            self.scalars = {}
        else:
            self.kernel = acoustic.acoustic_iso_kernel
            self.swap = ("p0", "p1")
            self.scalars = {"dt": 0.30000001192092896}      # f32(0.3)
        self.st = st
        self.halo = self.kernel.info.order

    def plan(self, codegen, shape, template):
        halos = {g: (self.halo,) * 3 for g in self.kernel.ir.grid_params}
        return codegen.plan_cuda(self.kernel.ir, halos, shape,
                                 self.st.hopper(template=template),
                                 swap=self.swap)

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
        from repro_torch.core import acoustic, suite
        from repro_torch.core import dsl as st
        from repro_torch.kernels.stencil import _build, codegen
        from repro_torch.kernels.stencil.fused_step import (fused_step,
                                                           fused_step_plain)
        from repro_torch.kernels.stencil.stream_step import (stream_step,
                                                            stream_step_plain)
    except ImportError as e:
        fail(f"cannot import the port from {ROOT / 'src'}: {e}")
    wrappers = {"fused_step": (fused_step, fused_step_plain),
                "stream_step": (stream_step, stream_step_plain)}
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

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    sources = [w.plan(codegen, MAIN_SHAPE, t).source()
               for w in workloads for t in TEMPLATES.values()]
    try:
        _build.build_many(sources)
    except RuntimeError as e:
        fail(f"build: {e}")
    build_s = time.perf_counter() - t0
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
        for kname, template in TEMPLATES.items():
            kern, plain = wrappers[kname]
            key = f"{kname}[{w.name}]"
            worst = 0.0
            for shape in shapes:
                plan = w.plan(codegen, shape, template)
                padded = plan.to_padded(w.arrays(torch, shape, seed=1))
                ref = {g: t.clone() for g, t in padded.items()}
                kern(plan, padded, w.scalars)
                plain(plan, ref, w.scalars)
                torch.cuda.synchronize()
                err = 0.0
                for g in plan.out_grids:
                    a, b = padded[g], ref[g]
                    if not bool(torch.isfinite(a).all()):
                        fail(f"{key} at {shape}: non-finite output")
                    err = max(err, float((a - b).abs().max()))
                    scale = max(1.0, float(b.abs().max()))
                    # f32 sums of 25 taps in another order, with FMA
                    # contraction on the card: a few ulp of the magnitude
                    if err > 2e-5 * scale:
                        fail(f"{key} at {shape}: max |kernel - plain| = "
                             f"{err} > 2e-5 * {scale}")
                worst = max(worst, err)
                say(f"kernel {key} {shape}: max abs err {err:.3g}")
                if shape == MAIN_SHAPE:
                    ms = time_ms(torch, lambda: kern(plan, padded, w.scalars),
                                 50, 10)
                    plain_ms = time_ms(torch, lambda: plain(plan, ref, w.scalars),
                                       2 if kname == "stream_step" else 5)
                    if w.name not in library:
                        library[w.name] = None
                        if w.name == "star3d4r":
                            lib_ms, lib_err = star_conv(torch, w, codegen,
                                                        fused_step_plain, ref)
                            library[w.name] = lib_ms
                            say(f"library conv3d[star3d4r] {shape}: "
                                f"{lib_ms:.4f} ms, max abs err vs plain "
                                f"{lib_err:.3g}")
                    info = w.kernel.info
                    n = np.prod(shape, dtype=np.float64)
                    nbytes = 4 * n * (len(info.input_grids)
                                      + len(info.output_grids))
                    nflop = info.flops_per_point * n
                    bound, bound_by = None, None
                    if rates is not None:
                        t_bytes = nbytes / rates[0] * 1e3
                        t_ops = nflop / rates[1] * 1e3
                        bound = max(t_bytes, t_ops)
                        bound_by = "bytes" if t_bytes >= t_ops else "operations"
                    entries[key] = {
                        "name": key, "route": "cuda",
                        "source": f"src/repro_torch/kernels/stencil/csrc/{kname}.cuh",
                        "replaces": REPLACES[kname], "launches": None,
                        "max_abs_err": None, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound, "bound_by": bound_by,
                        "library_ms": library[w.name],
                        "modeled_bytes_per_step": plan.hbm_bytes_per_step()}
                    say(f"time {key} {shape}: {ms:.4f} ms/step "
                        f"(plain {plain_ms:.2f} ms, bound {bound} ms, "
                        f"library {library[w.name]} ms)")
                del plan, padded, ref
            if key in entries:
                entries[key]["max_abs_err"] = worst
            torch.cuda.empty_cache()
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

    def acoustic_run(backend, fields):
        p0, p1, vp2, damp, dt = fields
        acoustic.inject_source(p1, 0)

        def between(t, grids):
            acoustic.inject_source(grids["p1"], t)
        return st.launch(backend=backend, fuse_steps=ACOUSTIC_FUSE)(
            acoustic.acoustic_target_fused)(p0, p1, vp2, damp, dt, STEPS,
                                            between=between).value

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
        for kname, template in TEMPLATES.items():
            key = f"{kname}[{w.name}]"
            fields = fresh()
            fused_step.launches = 0
            stream_step.launches = 0
            res = run(st.hopper(template=template), fields)
            counts = {"fused_step": fused_step.launches,
                      "stream_step": stream_step.launches}
            got = (fields if isinstance(fields, dict)
                   else dict(zip(("p0", "p1"), fields[:2])))
            if counts[kname] != STEPS or sum(counts.values()) != STEPS:
                fail(f"{key}: launch counts {counts}, expected {STEPS} "
                     f"of {kname}")
            entries[key]["launches"] = counts[kname]
            diff, scale = max_diff(torch, key, got, ref)
            n = float(np.prod(MAIN_SHAPE))
            steps_s = STEPS / res.seconds
            nbytes = 4 * n * (len(w.kernel.info.input_grids)
                              + len(w.kernel.info.output_grids))
            row = {"path": key, "template": template, "steps": STEPS,
                   "fuse_steps": res.fuse_steps, "seconds": res.seconds,
                   "steps_per_s": steps_s, "gpoints_per_s": steps_s * n / 1e9,
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
    ref_fields = fresh()
    acoustic_run(st.torch(), ref_fields)
    ref = dict(zip(("p0", "p1"), ref_fields[:2]))
    pml = init[3].data > 0              # damp's halo is 0: the PML's points
    share = (max(float(r.data[pml].abs().max()) for r in ref.values())
             / max(float(r.data.abs().max()) for r in ref.values()))
    if share < 1e-2:
        fail(f"acoustic at {PML_SHAPE}: the wave has not reached the PML "
             f"(max there {share} of the field's max)")
    pml_rows = []
    for template in TEMPLATES.values():
        key = f"acoustic_iso {PML_SHAPE} {template}"
        fields = fresh()
        acoustic_run(st.hopper(template=template), fields)
        diff, scale = max_diff(torch, key, dict(zip(("p0", "p1"), fields[:2])),
                               ref)
        pml_rows.append({"path": key, "max_abs_diff_vs_torch": diff,
                         "field_max": scale, "pml_share_of_max": share})
        say(f"absorbing boundary {key}: max |diff| vs st.torch() {diff:.3g} "
            f"(field max {scale:.3g}; in the PML {share:.2f} of it)")
    record["absorbing_boundary"] = pml_rows

    kernels = [entries[f"{k}[{w.name}]"] for w in workloads for k in TEMPLATES]
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
