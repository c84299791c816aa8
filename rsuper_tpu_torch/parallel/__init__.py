from .mesh import (DataParallel, current, data_parallel_size, gather_tree,
                   zero_partition)
from .multihost import init_distributed, is_primary, process_info

__all__ = ["DataParallel", "current", "data_parallel_size", "gather_tree",
           "zero_partition", "init_distributed", "is_primary",
           "process_info"]
