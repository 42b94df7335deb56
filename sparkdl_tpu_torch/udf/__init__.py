"""Model UDFs: the process-global catalog that ``sql.py`` resolves."""

from sparkdl_tpu_torch.udf.registry import (
    apply_udf,
    callUDF,
    get,
    list_udfs,
    makeGraphUDF,
    register,
    registerImageUDF,
    registerKerasImageUDF,
    registerModelUDF,
    sql_vectorize_enabled,
    unregister,
)

__all__ = [
    "apply_udf",
    "callUDF",
    "get",
    "list_udfs",
    "makeGraphUDF",
    "register",
    "registerImageUDF",
    "registerKerasImageUDF",
    "registerModelUDF",
    "sql_vectorize_enabled",
    "unregister",
]
