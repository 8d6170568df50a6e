"""Decoder models (the port of the reference's ``models`` for the dense and
MoE archs, with GQA or MLA attention): ``build(cfg)`` gives an ``nn.Module``
with init/apply/prefill/decode_step; prefill attention runs the flash kernel
on the card, and so does GQA's decode."""
from repro_torch.models.model import Model, build

__all__ = ["Model", "build"]
