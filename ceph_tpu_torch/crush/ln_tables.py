"""Fixed-point lookup tables for crush_ln (2^44 * log2(x+1)).

The port's copy of ``ceph_tpu/crush/ln_tables.py`` (unchanged).

The RH/LH table follows clean closed forms, verified entry-for-entry
against Ceph's src/crush/crush_ln_table.h:

    RH[k] = ceil(2^48 / (1 + k/128)) = ceil(2^55 / (128 + k))
    LH[k] = floor(2^48 * log2(1 + k/128)), with LH[128] pinned to
            0xffff00000000 (the table's documented top anchor)

so RH/LH are generated here at import time.

The LL table (2^48 * log2(1 + k/2^15), nominally) does NOT follow its
documented formula: most entries sit at a systematic ~0.443 index offset
with scattered irregular exceptions. Those exact values are part of
CRUSH's placement behavior - straw2 draws compare crush_ln outputs, so
any deviation changes mappings cluster-wide. They are therefore
behavioral protocol constants (reproduced verbatim for bit-compatibility,
the same way Ceph's Linux-kernel client duplicates them; see
crush_ln_table.h:94-96 and mapper.c:248-290).
"""

from __future__ import annotations

import numpy as np


def _floor_log2_scaled(num: int, den: int, scale_bits: int = 48) -> int:
    """floor(2^scale_bits * log2(num/den)) by exact binary digit extraction.

    Repeatedly squares num/den, emitting one bit of the base-2 logarithm
    per squaring. Fractions are truncated to 200-bit mantissas between
    steps - far more precision than the 48 digits extracted, so the floor
    is exact (verified entry-for-entry against the reference table).
    """
    from fractions import Fraction
    x = Fraction(num, den)
    ipart = x.numerator.bit_length() - x.denominator.bit_length()
    if x < Fraction(2) ** ipart:
        ipart -= 1
    result = ipart
    frac = x / (Fraction(2) ** ipart)   # in [1, 2)
    for _ in range(scale_bits):
        frac = frac * frac
        n, d = frac.numerator, frac.denominator
        shift = max(n.bit_length(), d.bit_length()) - 200
        if shift > 0:
            frac = Fraction(n >> shift, d >> shift)
        result <<= 1
        if frac >= 2:
            result += 1
            frac /= 2
    return result


def _make_rh_lh() -> np.ndarray:
    out = np.zeros(258, dtype=np.int64)
    for k in range(129):
        out[2 * k] = -(-(1 << 55) // (128 + k))  # ceil(2^55/(128+k))
        if k < 128 and k > 0:
            out[2 * k + 1] = _floor_log2_scaled(128 + k, 128)
    out[257] = 0xFFFF00000000
    return out


RH_LH_TBL = _make_rh_lh()

LL_TBL = np.array([
    0x000000000000, 0x0002e2a60a00, 0x00070cb64ec5, 0x0009ef50ce67,
    0x000cd1e588fd, 0x000fb4747e9c, 0x001296fdaf5e, 0x001579811b58,
    0x00185bfec2a1, 0x001b3e76a552, 0x001e20e8c380, 0x002103551d43,
    0x0023e5bbb2b2, 0x0026c81c83e4, 0x0029aa7790f0, 0x002c8cccd9ed,
    0x002f6f1c5ef2, 0x003251662017, 0x003533aa1d71, 0x003815e8571a,
    0x003af820cd26, 0x003dda537fae, 0x0040bc806ec8, 0x00439ea79a8c,
    0x004680c90310, 0x004962e4a86c, 0x004c44fa8ab6, 0x004f270aaa06,
    0x005209150672, 0x0054eb19a013, 0x0057cd1876fd, 0x005aaf118b4a,
    0x005d9104dd0f, 0x006072f26c64, 0x006354da3960, 0x006636bc441a,
    0x006918988ca8, 0x006bfa6f1322, 0x006edc3fd79f, 0x0071be0ada35,
    0x00749fd01afd, 0x0077818f9a0c, 0x007a6349577a, 0x007d44fd535e,
    0x008026ab8dce, 0x0083085406e3, 0x0085e9f6beb2, 0x0088cb93b552,
    0x008bad2aeadc, 0x008e8ebc5f65, 0x009170481305, 0x009451ce05d3,
    0x0097334e37e5, 0x009a14c8a953, 0x009cf63d5a33, 0x009fd7ac4a9d,
    0x00a2b07f3458, 0x00a59a78ea6a, 0x00a87bd699fb, 0x00ab5d2e8970,
    0x00ae3e80b8e3, 0x00b11fcd2869, 0x00b40113d818, 0x00b6e254c80a,
    0x00b9c38ff853, 0x00bca4c5690c, 0x00bf85f51a4a, 0x00c2671f0c26,
    0x00c548433eb6, 0x00c82961b211, 0x00cb0a7a664d, 0x00cdeb8d5b82,
    0x00d0cc9a91c8, 0x00d3ada20933, 0x00d68ea3c1dd, 0x00d96f9fbbdb,
    0x00dc5095f744, 0x00df31867430, 0x00e2127132b5, 0x00e4f35632ea,
    0x00e7d43574e6, 0x00eab50ef8c1, 0x00ed95e2be90, 0x00f076b0c66c,
    0x00f35779106a, 0x00f6383b9ca2, 0x00f918f86b2a, 0x00fbf9af7c1a,
    0x00feda60cf88, 0x0101bb0c658c, 0x01049bb23e3c, 0x01077c5259af,
    0x010a5cecb7fc, 0x010d3d81593a, 0x01101e103d7f, 0x0112fe9964e4,
    0x0115df1ccf7e, 0x0118bf9a7d64, 0x011ba0126ead, 0x011e8084a371,
    0x012160f11bc6, 0x01244157d7c3, 0x012721b8d77f, 0x012a02141b10,
    0x012ce269a28e, 0x012fc2b96e0f, 0x0132a3037daa, 0x01358347d177,
    0x01386386698c, 0x013b43bf45ff, 0x013e23f266e9, 0x0141041fcc5e,
    0x0143e4477678, 0x0146c469654b, 0x0149a48598f0, 0x014c849c117c,
    0x014f64accf08, 0x015244b7d1a9, 0x015524bd1976, 0x015804bca687,
    0x015ae4b678f2, 0x015dc4aa90ce, 0x0160a498ee31, 0x016384819134,
    0x0166646479ec, 0x01694441a870, 0x016c24191cd7, 0x016df6ca19bd,
    0x0171e3b6d7aa, 0x0174c37d1e44, 0x0177a33dab1c, 0x017a82f87e49,
    0x017d62ad97e2, 0x0180425cf7fe, 0x0182b07f3458, 0x018601aa8c19,
    0x0188e148c046, 0x018bc0e13b52, 0x018ea073fd52, 0x01918001065d,
    0x01945f88568b, 0x01973f09edf2, 0x019a1e85ccaa, 0x019cfdfbf2c8,
    0x019fdd6c6063, 0x01a2bcd71593, 0x01a59c3c126e, 0x01a87b9b570b,
    0x01ab5af4e380, 0x01ae3a48b7e5, 0x01b11996d450, 0x01b3f8df38d9,
    0x01b6d821e595, 0x01b9b75eda9b, 0x01bc96961803, 0x01bf75c79de3,
    0x01c254f36c51, 0x01c534198365, 0x01c81339e336, 0x01caf2548bd9,
    0x01cdd1697d67, 0x01d0b078b7f5, 0x01d38f823b9a, 0x01d66e86086d,
    0x01d94d841e86, 0x01dc2c7c7df9, 0x01df0b6f26df, 0x01e1ea5c194e,
    0x01e4c943555d, 0x01e7a824db23, 0x01ea8700aab5, 0x01ed65d6c42b,
    0x01f044a7279d, 0x01f32371d51f, 0x01f60236ccca, 0x01f8e0f60eb3,
    0x01fbbfaf9af3, 0x01fe9e63719e, 0x02017d1192cc, 0x02045bb9fe94,
    0x02073a5cb50d, 0x0209c06e6212, 0x020cf791026a, 0x020fd622997c,
    0x0212b07f3458, 0x02159334a8d8, 0x021871b52150, 0x021b502fe517,
    0x021d6a73a78f, 0x02210d144eee, 0x0223eb7df52c, 0x0226c9e1e713,
    0x0229a84024bb, 0x022c23679b4e, 0x022f64eb83a8, 0x02324338a51b,
    0x0235218012a9, 0x0237ffc1cc69, 0x023a2c3b0ea4, 0x023d13ee805b,
    0x024035e9221f, 0x0243788faf25, 0x024656b4e735, 0x0247ed646bfe,
    0x024c12ee3d98, 0x024ef1025c1a, 0x0251cf10c799, 0x025492644d65,
    0x02578b1c85ee, 0x025a6919d8f0, 0x025d13ee805b, 0x026025036716,
    0x026296453882, 0x0265e0d62b53, 0x0268beb701f3, 0x026b9c92265e,
    0x026d32f798a9, 0x0271583758eb, 0x02743601673b, 0x027713c5c3b0,
    0x0279f1846e5f, 0x027ccf3d6761, 0x027e6580aecb, 0x02828a9e44b3,
    0x028568462932, 0x0287bdbf5255, 0x028b2384de4a, 0x028d13ee805b,
    0x029035e9221f, 0x029296453882, 0x029699bdfb61, 0x029902a37aab,
    0x029c54b864c9, 0x029deabd1083, 0x02a20f9c0bb5, 0x02a4c7605d61,
    0x02a7bdbf5255, 0x02a96056dafc, 0x02ac3daf14ef, 0x02af1b019eca,
    0x02b296453882, 0x02b5d022d80f, 0x02b8fa471cb3, 0x02ba9012e713,
    0x02bd6d4901cc, 0x02c04a796cf6, 0x02c327a428a6, 0x02c61a5e8f4c,
    0x02c8e1e891f6, 0x02cbbf023fc2, 0x02ce9c163e6e, 0x02d179248e13,
    0x02d4562d2ec6, 0x02d73330209d, 0x02da102d63b0, 0x02dced24f814,
], dtype=np.int64)
