"""``python -m repro_torch.workloads.run`` — CLI entry for the workload zoo.

Thin shim over ``repro_torch.workloads.runner`` (which holds the machinery), so
the module path in the docs stays short.
"""
from .runner import main

if __name__ == "__main__":
    main()
