"""Lakehouse table formats — counterpart of `spark_rapids_tpu/lakehouse`:
Delta Lake (delta.py, deletion_vectors.py). Iceberg is not ported yet
(ROADMAP A14): its manifests are Avro files, and the Avro reader
(`io/avro.py`) is not ported either."""

from spark_rapids_tpu_torch.lakehouse.delta import (  # noqa: F401
    DeltaTable,
    read_delta,
    write_delta,
)


def read_iceberg(session, path: str, *args, **kwargs):
    """The reference's Iceberg read; not ported yet."""
    raise NotImplementedError(
        "Iceberg tables are not ported yet (ROADMAP A14: "
        "lakehouse/iceberg.py and the Avro manifests of io/avro.py)")
