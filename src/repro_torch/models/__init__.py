"""Dense GQA decoder models (the port of the reference's ``models`` for the
dense archs): ``build(cfg)`` gives an ``nn.Module`` with
init/apply/prefill/decode_step; attention runs the flash kernel on the card."""
from repro_torch.models.model import Model, build

__all__ = ["Model", "build"]
