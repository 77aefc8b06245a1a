"""Process start to the first timed job: genome, FASTA, index build, kernel
load, the warm job (host clock)."""


def read(record):
    return record["setup"]["setup_s"]
