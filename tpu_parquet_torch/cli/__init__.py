"""CLI tools: pq_tool (cat/head/meta/schema/rowcount/split) and csv2parquet.

Equivalents of the reference's cmd/parquet-tool (cobra CLI, cmd/parquet-tool/
cmds/*.go) and cmd/csv2parquet (cmd/csv2parquet/main.go:24-435).
"""
