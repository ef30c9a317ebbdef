"""The example programs of the port, run as modules
(``python -m tenzing_tpu_torch.examples.spmv_dfs``)."""
