"""The plain reference of each model the benchmark runs, in plain
PyTorch, apart from the program: it imports nothing of it and takes
nothing it made. A configuration's "reference" key names its module here
(`wdl.py`, `dfm.py`); `train.py` is plain SGD over any of them and
`precision.py` the products of the checks' controls."""
