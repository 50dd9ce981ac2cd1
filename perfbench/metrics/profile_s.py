"""Seconds of ``sample_angle_profile`` (``core/angles.py``), by the
harness's clock."""


def read(record):
    return record["spans"].get("profile")
