"""Row-sharded training over a torch.distributed process group (routing
"alltoall", and the legacy "psum"): counterpart of
anime_recommendations_tpu/parallel/."""

from anime_recommendations_tpu_torch.parallel.mesh import World, make_world, mesh_shape_for
from anime_recommendations_tpu_torch.parallel.sharded_train import ShardedTrainStep
from anime_recommendations_tpu_torch.parallel.trainer import ShardedTrainer

__all__ = ["World", "make_world", "mesh_shape_for", "ShardedTrainStep", "ShardedTrainer"]
