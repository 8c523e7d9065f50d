"""K7: flash decode attention (``ops.decode_attention``), its CUDA kernel
(``decode_attn.decode_attention_cuda``, ``csrc/decode_attn.cu``) and plain
version (``ref.decode_attention_ref``)."""
from . import decode_attn, ops, ref  # noqa: F401
