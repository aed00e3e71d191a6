"""MPDCompress core of the port: masks, permutations, policy, fold gathers,
the MPD linear layer and the quantize pass."""
