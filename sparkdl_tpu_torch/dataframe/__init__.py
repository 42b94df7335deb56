from sparkdl_tpu_torch.dataframe.frame import DataFrame, Row
from sparkdl_tpu_torch.dataframe.window import Window, WindowSpec

__all__ = ["DataFrame", "Row", "Window", "WindowSpec"]
