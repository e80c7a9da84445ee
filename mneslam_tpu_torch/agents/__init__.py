"""Multi-agent collaboration: place recognition, comms, loop closure and
map fusion (port of `mneslam_tpu/agents/`)."""
