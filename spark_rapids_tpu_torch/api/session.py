"""Session: the SparkSession-shaped entry point (the counterpart of
spark_rapids_tpu/api/session.py) over in-memory numpy tables."""
from __future__ import annotations

from typing import Dict, Optional, Union

from spark_rapids_tpu_torch import DEFAULT_DEVICE
from spark_rapids_tpu_torch.api.dataframe import DataFrame
from spark_rapids_tpu_torch.columnar.batch import Schema
from spark_rapids_tpu_torch.plan import nodes as pn


class Session:
    """Holds the conf (``plan.overrides`` keys), the device every query
    runs on (the card unless the caller passes ``device="cpu"``) and the
    catalog ``sql`` resolves table names in."""

    def __init__(self, conf: Optional[Dict] = None, device=DEFAULT_DEVICE):
        self.conf = dict(conf or {})
        self.device = device
        self._catalog: Dict[str, Union[pn.PlanNode, pn.InMemorySource]] = {}

    def create_dataframe(self, data: dict, schema: Optional[Schema] = None,
                         validity: Optional[dict] = None) -> DataFrame:
        """A DataFrame over host columns: ``data`` maps name -> numpy
        array (object arrays for strings, None = null), ``validity`` name
        -> bool mask."""
        return DataFrame(pn.ScanNode(pn.InMemorySource(
            dict(data), schema=schema, validity=validity)), self)

    createDataFrame = create_dataframe

    def create_temp_view(self, name: str, target) -> None:
        """Register a DataFrame, an InMemorySource or a plan under
        ``name`` for :meth:`sql` (createOrReplaceTempView)."""
        if isinstance(target, DataFrame):
            target = target._plan
        if not isinstance(target, (pn.PlanNode, pn.InMemorySource)):
            raise TypeError(f"cannot register {type(target).__name__} as "
                            "a table")
        self._catalog[name] = target

    createOrReplaceTempView = create_temp_view

    def sql(self, query: str) -> DataFrame:
        """Parse and plan a SELECT over the catalog; returns a lazy
        DataFrame. What the port cannot plan raises SqlError."""
        from spark_rapids_tpu_torch.sql import parse, plan_statement

        return DataFrame(plan_statement(parse(query), self._catalog), self)
