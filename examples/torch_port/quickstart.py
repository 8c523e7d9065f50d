"""Quickstart on the PyTorch/CUDA port: paper Listing 1, a star2d4r stencil
in the StencilPy DSL.

    PYTHONPATH=src python examples/torch_port/quickstart.py              # card
    PYTHONPATH=src python examples/torch_port/quickstart.py --device cpu

Writes the kernel once and runs 50 steps at 256² on the plain PyTorch
backend (``st.torch()``, the reference) and on the Hopper backend: one
``st.map`` a step (the per-application kernel K4, gmem template, Listing
1's ``st.cuda(...)`` form), then the fused ``st.timeloop`` (the fused-step
kernel K1) beside ``st.torch()``'s.  Prints each launch's phase profile
(codegen / layout / kernel seconds: paper Tables 6-8 columns).  On CPU
tensors the Hopper backend runs its kernels' plain PyTorch versions.
"""
import argparse

from repro_torch.core import dsl as st

SHAPE = (256, 256)
ITERS = 50


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


@st.target
def target_star2d4r(u: st.grid, v: st.grid, iters: st.i32):
    for _t in range(iters):
        st.map(e=u.shape)(kernel_star2d4r)(u, v)
        (u.data, v.data) = (v.data, u.data)


@st.target
def target_fused(u: st.grid, v: st.grid, iters: st.i32):
    return st.timeloop(iters, swap=("v", "u"))(kernel_star2d4r)(u, v)


def grids(device):
    """The initial pair: ``u`` from ``randomize(0)`` (the JAX package's
    draw, bit for bit), ``v`` zero."""
    u = st.grid(dtype=st.f32, shape=SHAPE, order=4, device=device).randomize(0)
    v = st.grid(dtype=st.f32, shape=SHAPE, order=4, device=device)
    return u, v


def per_step(backend, device):
    """``ITERS`` ``st.map`` applications → (final ``u`` interior, profile)."""
    u, v = grids(device)
    res = st.launch(backend=backend)(target_star2d4r)(u, v, ITERS)
    return u.interior.clone(), res.profile


def fused(backend, device):
    """The same steps as one fused ``st.timeloop`` → (final ``u``
    interior, its ``TimeloopResult``)."""
    u, v = grids(device)
    res = st.launch(backend=backend)(target_fused)(u, v, ITERS)
    return u.interior.clone(), res.value


def _rounded(profile):
    return {k: round(t, 4) for k, t in profile.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for tests)")
    args = ap.parse_args(argv)
    device = st.resolve_device(args.device)

    print(kernel_star2d4r)          # parsed stencil info (shape/order/FLOPs)

    ref, prof = per_step(st.torch(), device)
    print("torch profile:", _rounded(prof))

    # Listing 1's form: st.cuda(threadsPerBlock=...) is st.hopper(block=...)
    hop = st.cuda(computeCapability="9.0", threadsPerBlock=(8, 128),
                  template="gmem")
    got, prof2 = per_step(hop, device)
    print("hopper profile:", _rounded(prof2))
    err = float((got - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    print(f"max |hopper - torch| = {err:.3e} (relative {err / scale:.3e})")
    # this stencil amplifies oscillatory modes (paper's own coefficients),
    # so compare at fp32-relative accuracy
    assert err / scale < 1e-5

    # fused time loop: the same steps in one window, one host sync in
    # all, on each backend against its own per-step run
    out = {"max_abs_hopper_vs_torch": err, "relative_hopper_vs_torch":
           err / scale, "field_max": float(ref.abs().max())}
    for name, backend, want in (("torch", st.torch(), ref),
                                ("hopper", st.hopper(), got)):
        u3, tl = fused(backend, device)
        err3 = float((u3 - want).abs().max())
        print(f"fused timeloop ({name}): {tl.steps} steps in {tl.windows} "
              f"window(s), {tl.steps_per_s:.0f} steps/s, max |fused - "
              f"per-step| = {err3:.3e}")
        assert err3 / scale < 1e-6
        out[f"fused_{name}_steps_per_s"] = tl.steps_per_s
        out[f"max_abs_fused_{name}_vs_per_step"] = err3
    print("OK")
    return out


if __name__ == "__main__":
    main()
