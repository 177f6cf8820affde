"""Test-set loading: the port's own copies of uegan_tpu/data/{files,dataset}.py
and of the test-loader part of uegan_tpu/data/pipeline.py."""
