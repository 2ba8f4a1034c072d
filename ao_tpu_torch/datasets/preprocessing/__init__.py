"""Dataset preprocessors (port of ao_tpu/datasets/preprocessing/)."""
