"""Public API: Config / Context session state machine and the speed
presets.

Reference parity: rav1e src/api/ (Config, Context<T>, send_frame /
receive_packet / flush, EncoderStatus), with rav1e-compatible
configuration key names.
"""

from rav1e_tpu_torch.api.context import (  # noqa: F401
    Config,
    Context,
    EncoderStatus,
    Packet,
)
