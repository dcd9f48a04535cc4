"""Data layer of the port: preprocessing, datasets, loaders, samplers
(ports ``wavernn_tpu/data``; ref: preprocess.py, utils/dataset.py)."""
