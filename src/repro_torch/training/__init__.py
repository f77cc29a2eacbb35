"""Training: AdamW, LR schedules, the microbatched train step and the
msgpack checkpoints."""
