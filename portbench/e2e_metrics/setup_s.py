"""From the process's start to the window's: imports, the card's context,
loading (the first run of a checkout: building) the kernel libraries,
making the inputs, warming every shape."""


def read(record):
    return record["setup_s"]
