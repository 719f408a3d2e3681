"""Training data of the port: the LKGD fine-tune dataset and a prefetching loader."""
