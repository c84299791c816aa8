"""The host data layer (numpy/scipy, the native host library where it is
built) and the device augmentation of the training CLI: the port's own
copies of the modules of ``rsuper_tpu/data/``."""
