"""The training harness: train step, optimizers' schedules, flat buffer and
fused LAMB, loop, checkpoints, logging and configuration."""
