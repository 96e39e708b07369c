"""Command-line scripts of the port: ``python -m pytorch_sound_tpu_torch.scripts.preprocess``."""
