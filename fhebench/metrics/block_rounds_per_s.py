"""AES block-rounds (blocks x rounds) completed over the whole window, host
clock; a full cipher is 10 block-rounds a block."""


def read(run):
    return run.block_rounds / run.seconds if run.seconds > 0 else None
