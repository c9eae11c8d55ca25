"""Parallel paths of the port (counterpart of audiodec_tpu/parallel/): the
meshes of ranks, the multi-process runtime, the chunk-halo
sequence-parallel codec and the channel-parallel codec, on
torch.distributed with one rank per device (parallel/distributed.py says
how the backend is chosen)."""

from audiodec_tpu_torch.parallel.mesh import Mesh, make_mesh
from audiodec_tpu_torch.parallel.codec import (
    decoder_halo_frames,
    encoder_halo_samples,
    make_sharded_codec,
)
from audiodec_tpu_torch.parallel.tp import (
    generator_tp_specs,
    make_tp_codec,
    make_tp_mesh,
)
from audiodec_tpu_torch.parallel.distributed import (
    global_mesh,
    global_to_host_local,
    host_local_rows,
    host_local_to_global,
    init_distributed,
    local_block,
    process_shard,
)
