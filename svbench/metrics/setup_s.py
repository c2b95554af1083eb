"""Host seconds from the start of the run's script to the first sample:
generating (or reading) the seed's sample, importing the port, loading
or building its native and CUDA libraries."""


def read(run):
    return run["setup_s"]
