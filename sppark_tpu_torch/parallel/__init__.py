"""The sharded paths over torch.distributed (the subsystem sppark does not
have): the port of sppark_tpu/parallel.  One process drives one device;
a `Mesh` is a process group from one rank's side (mesh.py).

  * NTT: the four-step decomposition, the local column and row NTTs on
    the port's NTT path, one `all_to_all_single` from column to row
    shards (ntt.py);
  * MSM: each rank's block of terms through the mode-"xyzz" rounds, the
    per-window sums all-gathered and folded (msm.py);
  * dryrun: both on a mesh against the oracle (dryrun.py).
"""

from .dryrun import dryrun
from .mesh import (Mesh, destroy, init_distributed, local_mesh, make_mesh,
                   rank_device)
from .msm import msm_sharded
from .ntt import ntt_matrix_sharded, ntt_sharded

__all__ = ["Mesh", "init_distributed", "make_mesh", "local_mesh",
           "rank_device", "destroy", "ntt_sharded", "ntt_matrix_sharded",
           "msm_sharded", "dryrun"]
