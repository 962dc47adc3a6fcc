"""Offline data tools (port of the JAX package's ``data/preprocess``): MOD's
raw CSV dumps to ``.npz`` sample files (``mod``), and those to the index
files a recipe names (``partition``). numpy only; no device."""
