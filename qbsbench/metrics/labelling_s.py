"""Wall time of ``build_labelling`` as ``QbSIndex.build`` calls it, with a
synchronise, in s."""


def read(raw):
    return raw.get("labelling_s")
