"""Readers of the files that `map` writes, one module per output kind (the
harness finds `outputs/<kind>.py` by the kind's name).  Each module has

  suffix(flags) -> str      the file name's ending after `<base>.genmap`
  read(path, genome, flags) -> np.ndarray
                            the value of every position of the genome
  expect(freq, flags) -> np.ndarray
                            the values the file holds for these frequencies
"""
