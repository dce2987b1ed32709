"""File inputs of the port: path expansion and parquet reading."""
