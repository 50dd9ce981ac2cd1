"""Process start to the first timed query: vectors, K-NN build, angle
profile, engine set-up and the warm-up batch (host clock)."""


def read(record):
    return record["setup_s"]
