"""Scale-out over several devices: the relay mesh and its sharded steps.

The reference scales across machines with a control plane (Redis
presence and EasyCMS redirection) and across cores with its task
threads.  Over several cards the analogous axes are mesh dimensions:

* ``src``: relay sources sharded across devices (the data-parallel axis,
  and the megabatch scheduler's serving mesh);
* ``sub``: subscriber blocks sharded across devices (each renders the
  headers of its slice of subscribers);
* ``win``: the packet window sharded across devices (the keyframe scan
  becomes a max over ``win``).

``mesh`` holds the mesh and B8, ``sharded_relay_step``; ``distributed``
the process group a mesh may span; ``megabench`` the paired mesh-vs-one-
device throughput harness of the megabatch scheduler.
"""

from .distributed import (init_from_env, make_cluster_mesh,  # noqa: F401
                          mesh_summary, process_span)
from .mesh import (RelayMesh, example_batch,  # noqa: F401
                   make_megabatch_mesh, make_relay_mesh, sharded_relay_step)
