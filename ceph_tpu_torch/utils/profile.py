"""Erasure-code profiles: the key=value configuration contract.

Port of ``ceph_tpu/utils/profile.py`` (a copy: the port imports nothing
of ceph_tpu).

Reproduces the semantics of the reference's profile helpers
(/root/reference/src/erasure-code/ErasureCode.cc:235-304): missing or empty
values fall back to (and are written back as) the default, malformed ints
report an error but still set the default, booleans accept yes/true, and
the "mapping" string (D = data position) produces the chunk remap vector.

A profile is a plain dict[str, str]; codecs mutate it in place (the
reference echoes resolved defaults back into the profile, and the registry
compares the echo — ErasureCodePlugin.cc:114-118).
"""

from __future__ import annotations

import errno

from ..errors import ErasureCodeError


def to_int(name: str, profile: dict, default: str, errors: list | None = None) -> int:
    if not profile.get(name):
        profile[name] = default
    try:
        return int(profile[name], 10)
    except ValueError:
        # Reference to_int sets the default back and fails init with
        # -EINVAL (ErasureCode.cc:256-277) — a typo'd profile must never
        # silently become a different geometry.
        msg = ("could not convert %s=%s to int, set to default %s"
               % (name, profile[name], default))
        if errors is not None:
            errors.append(msg)
        profile[name] = default
        raise ErasureCodeError(errno.EINVAL, msg)


def to_bool(name: str, profile: dict, default: str) -> bool:
    if not profile.get(name):
        profile[name] = default
    return profile[name] in ("yes", "true")


def to_string(name: str, profile: dict, default: str) -> str:
    if not profile.get(name):
        profile[name] = default
    return profile[name]


def to_mapping(profile: dict) -> list[int]:
    """Parse the "mapping" string into the chunk remap vector.

    'D' marks a data position; the remap lists data positions first then
    coding positions, in order of appearance (ErasureCode.cc:235-254).
    Returns [] when no remapping is requested.
    """
    mapping = profile.get("mapping")
    if not mapping:
        return []
    data = [i for i, c in enumerate(mapping) if c == "D"]
    coding = [i for i, c in enumerate(mapping) if c != "D"]
    return data + coding
