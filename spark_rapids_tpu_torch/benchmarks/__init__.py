"""Workloads of the port: TPCx-BB q26, TPC-H q14 and q22, and the q5lite
step."""
