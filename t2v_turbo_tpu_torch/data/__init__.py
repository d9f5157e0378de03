"""The data layer: tar shards and CSV-indexed mp4s -> decoded, resized and
cropped clips (port of t2v_turbo_tpu/data, without PIL)."""
