"""The four assigned input shapes (the port's copy of
``repro/configs/shapes.py``, with ``InputShape`` from the reference's
``configs/base.py``)."""

import dataclasses


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                      # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", seq_len=4096, global_batch=256,
                      mode="train")
PREFILL_32K = InputShape("prefill_32k", seq_len=32768, global_batch=32,
                         mode="prefill")
DECODE_32K = InputShape("decode_32k", seq_len=32768, global_batch=128,
                        mode="decode")
LONG_500K = InputShape("long_500k", seq_len=524288, global_batch=1,
                       mode="decode")

SHAPES = {s.name: s for s in
          (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

# Window applied to full-attention archs for long_500k ONLY: keeps the
# decode cache bounded/sub-quadratic; SSM/hybrid decode natively.
LONG_CONTEXT_WINDOW = 8192
