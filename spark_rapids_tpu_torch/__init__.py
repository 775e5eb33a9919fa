"""PyTorch and CUDA port of spark_rapids_tpu for NVIDIA Hopper.

The JAX package ``spark_rapids_tpu`` is the reference; this package does
the same relational work on torch tensors and never imports it (nor JAX,
pandas or pyarrow). What is ported so far is the path of TPCx-BB q26 and
TPC-H q14 and q22 through the unfused exec tree, of the q5lite
filter-groupby step, and of SQL text and DataFrame queries over
in-memory numpy tables through the front end (TPC-DS q91):

    api.Session.sql -> sql.parse -> sql.plan_statement -> plan.nodes
      -> plan.overrides.apply_overrides -> execs -> ops
      -> kernels (CUDA C++ for sm_90a, loaded with ctypes)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on CPU tensors every kernel wrapper runs its plain PyTorch version.
"""

DEFAULT_DEVICE = "cuda"
