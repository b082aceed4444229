"""Multi-GPU training: the process group (`distributed.py`) and the (data x
tile) train step (`sharding.py`)."""
