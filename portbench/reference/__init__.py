"""The benchmark's plain PyTorch reference of UEGAN (``nets.py``: G, D, VGG19
and the losses; ``train.py``: the train step, the pool and Adam).  It
imports nothing of the program under test and takes no weight, scale or
table the program made: the benchmark hands both the same seeded weights."""
