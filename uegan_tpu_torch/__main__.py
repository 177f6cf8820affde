from uegan_tpu_torch.cli import run

run()
