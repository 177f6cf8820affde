"""The HTTP service, counterpart of uegan_tpu/serve/."""
