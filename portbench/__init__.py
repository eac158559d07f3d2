"""The benchmark of the PyTorch and CUDA port (`beatrice_vst_tpu_torch`):
how many real-time voice streams its engine carries on one card.  See
`run.py` for the command and `BENCHMARK.json` at the repository root for
the cells and metrics."""
