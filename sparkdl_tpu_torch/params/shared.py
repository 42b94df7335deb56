"""Shared Param mixins: column names, batch size, model function."""

from __future__ import annotations

from sparkdl_tpu_torch.params.base import Param, Params, TypeConverters


class HasInputCol(Params):
    inputCol = Param(
        None, "inputCol", "name of the input column", TypeConverters.toString
    )

    def setInputCol(self, value: str):
        return self._set(inputCol=value)

    def getInputCol(self) -> str:
        return self.getOrDefault(self.inputCol)


class HasOutputCol(Params):
    outputCol = Param(
        None, "outputCol", "name of the output column", TypeConverters.toString
    )

    def setOutputCol(self, value: str):
        return self._set(outputCol=value)

    def getOutputCol(self) -> str:
        return self.getOrDefault(self.outputCol)


class HasBatchSize(Params):
    batchSize = Param(
        None,
        "batchSize",
        "device batch size for model execution; the tail batch is "
        "zero-padded to this size",
        TypeConverters.toInt,
    )

    def setBatchSize(self, value: int):
        return self._set(batchSize=value)

    def getBatchSize(self) -> int:
        return self.getOrDefault(self.batchSize)


class HasModelFunction(Params):
    """Param holding a ModelFunction (see sparkdl_tpu_torch.graph.function)."""

    modelFunction = Param(
        None,
        "modelFunction",
        "ModelFunction to apply (torch module + device)",
        TypeConverters.identity,
    )

    def setModelFunction(self, value):
        return self._set(modelFunction=value)

    def getModelFunction(self):
        return self.getOrDefault(self.modelFunction)
