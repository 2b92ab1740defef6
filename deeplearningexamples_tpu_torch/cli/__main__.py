"""``python -m deeplearningexamples_tpu_torch.cli <model> [flags]``."""

from .main import cli

if __name__ == "__main__":
    cli()
