"""Host-side volume IO and preprocessing (numpy/scipy), the port's own
copies of ``rsuper_tpu/data/nifti.py`` and ``rsuper_tpu/data/preprocess.py``."""
