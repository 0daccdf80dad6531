"""Launchers of the port (``repro.launch``): mesh construction, input
stand-ins and their placements, the coded training CLI
(``python -m repro_torch.launch.train``) and the meta-device dry run
(``python -m repro_torch.launch.dryrun``) with H100 roofline terms.

Importing this package creates no process group: the dry run creates its
fake 512-rank group in ``main`` only.
"""
from .mesh import make_local_mesh, make_production_mesh
