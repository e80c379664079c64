"""Runtime of the port (counterpart of lele_tpu.runtime): `CompiledModel`
(runtime.engine), one captured program a bucket (runtime.graphs), length
bucketing (runtime.bucketing), composed models (runtime.compose), and
generative decoding (runtime.decode, runtime.seq2seq)."""

from .compose import compose_models  # noqa: F401
from .decode import StaticKVDecoder  # noqa: F401
from .seq2seq import Seq2SeqGenerator  # noqa: F401
