"""The typed configuration registry (a copy of the reference's)."""

from spark_rapids_tpu_torch.config.rapids_conf import (  # noqa: F401
    ConfEntry,
    RapidsConf,
    conf_entries,
)
