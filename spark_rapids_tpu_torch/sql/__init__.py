"""SQL front end (the counterpart of spark_rapids_tpu/sql): parse a
SELECT statement and plan it into the port's plan nodes.

    SELECT [DISTINCT] exprs FROM t [, u ...] [JOIN v ON ...] [WHERE ...]
    [GROUP BY ...] [HAVING ...] [ORDER BY ...] [LIMIT n]

The parser is the reference's grammar in full; the planner plans what
the port can run and raises ``SqlError`` for the rest, naming what is not
ported yet. Tables resolve through the session catalog
(``Session.create_temp_view`` / ``Session.sql``).
"""
from spark_rapids_tpu_torch.sql.parser import SqlError, parse  # noqa: F401
from spark_rapids_tpu_torch.sql.planner import plan_statement  # noqa: F401
