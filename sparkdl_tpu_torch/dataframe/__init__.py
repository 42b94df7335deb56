from sparkdl_tpu_torch.dataframe.frame import DataFrame, Row

__all__ = ["DataFrame", "Row"]
