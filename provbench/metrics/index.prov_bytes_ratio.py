"""The index's own count of its provenance bytes
(``ProvenanceIndex.stats()["prov_bytes"]``) over the input tables' bytes."""


def read(rec):
    if "prov_bytes" not in rec:
        return None
    return rec["prov_bytes"] / rec["input_bytes"]
