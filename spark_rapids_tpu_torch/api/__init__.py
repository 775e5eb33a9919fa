"""User-facing SQL and DataFrame API (the counterpart of
spark_rapids_tpu/api) over in-memory numpy tables:

    from spark_rapids_tpu_torch.api import Session, col, functions as F

    s = Session()                      # runs on the card; device="cpu" too
    s.create_temp_view("t", s.create_dataframe({"k": keys, "v": vals}))
    out = s.sql("SELECT k, sum(v) AS sv FROM t GROUP BY k ORDER BY k")
    cols = out.collect()               # dict of numpy columns

    df = (s.create_dataframe(data).filter(col("s").like("a%"))
           .group_by("k").agg(F.sum(col("v")).alias("sv")))

``collect`` returns name -> numpy array, not a pandas frame. There is no
reader, query service, runtime, streaming or cache here yet.
"""
from spark_rapids_tpu_torch.api import functions  # noqa: F401
from spark_rapids_tpu_torch.api.column import Column, col, lit  # noqa: F401
from spark_rapids_tpu_torch.api.dataframe import (DataFrame,  # noqa: F401
                                                  GroupedData)
from spark_rapids_tpu_torch.api.session import Session  # noqa: F401

__all__ = ["Session", "DataFrame", "GroupedData", "Column", "col", "lit",
           "functions"]
