"""Training substrate (counterpart of ``repro.train``): AdamW with int8
gradient compression, the train step, atomic checkpoints."""
