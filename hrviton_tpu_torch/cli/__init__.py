"""Command-line entry points: ``python -m hrviton_tpu_torch.cli.test_generator``."""
