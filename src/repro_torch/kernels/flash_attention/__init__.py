"""Blocked online-softmax attention with GQA (the counterpart of the reference kernel of the same name)."""
