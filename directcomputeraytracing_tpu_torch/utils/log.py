"""The package's logger: standard `logging` under the "dcrt" name, the
reference's (`directcomputeraytracing_tpu.utils.log`). Enable it with
DCRT_LOG=1 (info) or DCRT_LOG=debug.
"""

import logging
import os

logger = logging.getLogger("dcrt")

_level = os.environ.get("DCRT_LOG")
if _level:
    logging.basicConfig()
    logger.setLevel(logging.DEBUG if _level.lower() == "debug"
                    else logging.INFO)
