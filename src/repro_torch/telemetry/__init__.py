"""Measurement on the card: :mod:`repro_torch.telemetry.timing`."""
