"""Workloads of the port: TPCx-BB q26 and the q5lite step."""
