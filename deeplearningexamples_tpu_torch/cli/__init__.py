"""The training CLI of the port: ``python -m deeplearningexamples_tpu_torch.cli
bert-pretrain [flags]``."""
