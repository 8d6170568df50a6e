"""Training (the port of the reference's ``train``): the Zipf bigram data
stream, AdamW, int8 gradient compression, the train step, checkpoints in the
reference's format, and the fault-tolerant trainer."""
