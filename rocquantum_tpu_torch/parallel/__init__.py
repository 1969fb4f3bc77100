from .mesh import (BATCH_AXIS, DCN_AXIS, SV_AXIS, Mesh,  # noqa: F401
                   default_mesh, make_mesh, make_mesh_2d, make_mesh_multislice)
from .sharded import (  # noqa: F401
    ShardedState,
    StateSharding,
    count_collectives,
    num_global_qubits,
    reset_collectives,
    shard_state,
    sharded_init_state,
    state_sharding,
    swap_index_bits_sharded,
)
