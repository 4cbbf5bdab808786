"""SST block codec names, as far as the port's `none` layout needs them.

The port writes and reads the raw columnar layout (codec `none`, the
JAX package's `[pegasus.storage] block_codec = none`): such files carry
no `codec` key in their index. Files whose index names the compressed
`dcz`/`dcz2` codecs are refused at open with a clear error; their
decoder is not part of the port yet.
"""

from __future__ import annotations

CODEC_DCZ = "dcz"
CODEC_DCZ2 = "dcz2"
KNOWN_CODECS = (CODEC_DCZ, CODEC_DCZ2)
