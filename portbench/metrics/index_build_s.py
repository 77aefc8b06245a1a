"""Host seconds of the `index` command in set-up."""


def read(record):
    return record["setup"]["index_build_s"]
