from stellar_tpu_torch.database.database import (  # noqa: F401
    Database, NodePersistence, PersistentState,
)
