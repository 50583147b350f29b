from guassianhand_tpu_torch.parallel.mesh import (batch_sharding, make_mesh,
                                                  replicated)
from guassianhand_tpu_torch.parallel.step import (make_sharded_fit_step,
                                                  shard_batch)
