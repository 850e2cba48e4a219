"""Multi-device layer: one controller over a list of devices (port of
``neural_spectral_codec_tpu/parallel/``).

  * ``mesh.py``: ``Mesh`` (devices along one ``"data"`` axis, repeats
    allowed for logical shards), ``create_mesh`` and the placement
    helpers;
  * ``encode.py``: batch-sharded descriptor encoding, the general and the
    ring path, one slab of scans per device;
  * ``retrieval.py``: the row-sharded W₁ database (local top-k per slab,
    a global top-k of the gathered candidates);
  * ``train.py``: data-parallel and node-sharded train steps and the
    sharded eval forward;
  * ``dryrun.py``: ``dryrun_multichip``, one pass over all of the above.
"""

from neural_spectral_codec_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    create_mesh,
    data_sharding,
    replicate,
    shard_array,
)
from neural_spectral_codec_torch.parallel.encode import (  # noqa: F401
    make_sharded_encoder,
)
from neural_spectral_codec_torch.parallel.train import (  # noqa: F401
    make_sharded_train_step,
    pad_to_multiple,
)
from neural_spectral_codec_torch.parallel.retrieval import (  # noqa: F401
    ShardedWassersteinRetriever,
)
