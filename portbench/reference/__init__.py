"""Plain PyTorch references, one a stencil, frozen copies of the updates
the program's DSL kernels state.  They import nothing of the program (nor
JAX or the JAX package) and take only the benchmark's inputs.  Each
offers ``prepare(state, scalars, cfg) -> scratch`` (what the update needs
beside the state, worked out from the inputs once) and
``update(state, scratch, cfg)`` (one step: the written grid's interior in
place); a stencil with a source and receivers adds ``inject(state, t,
cfg)`` and ``record(state, cfg)``.  Each step is a few whole-grid
PyTorch operations in f32, so a 512³ solve runs on the card in seconds."""
