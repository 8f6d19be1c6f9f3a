"""A JPEG 2000 writer with HT code-blocks (ITU-T T.814 | ISO/IEC
15444-15, "HTJ2K"), for the tests of the port's decoder: the encoders
the tests have write none (OpenJPEG's has no HT path), so this module
does, and PIL (OpenJPEG 2.5.4, which decodes them) is the
oracle: a lossless stream must decode in PIL to its source samples, and
every stream is held port == PIL bit for bit.

:func:`encode` writes a whole codestream: SIZ with Rsiz 0x4000 and a CAP
segment, COD with code-block style 0x40 (0x48: vertically causal), QCD,
one or more tiles (image and tile offsets), each tile's packets in LRCP
order over one or more quality layers. Each tile-component goes through
this module's forward 5/3 (integer lifting, lossless) or 9/7 (float,
with scalar quantization) DWT, after the DC level shift and the RCT or
ICT. Each code-block is coded by the HT block coder:

- the cleanup pass at a chosen bit plane ``p``: the MEL run coder (13
  states), the context-adaptive VLC of each quad's significance, EMB
  pattern and ``u_off`` (the two tables below: the first quad row and the
  others), the U-VLC of the pair's unsigned residual exponents (with the
  first row's MEL-signalled pair rule) and the MagSgn bits, each stream
  with its own bit stuffing, MEL and VLC sharing the segment's tail and
  the last 12 bits giving its length ``Scup``;
- optionally SigProp (raw bits, forward) and MagRef (raw bits, backward)
  for bit plane ``p - 1``, in the refinement segment.

The tier-2 writer codes inclusion and zero-bit-plane tag trees, the pass
counts, ``Lblock`` and one length per codeword segment (the cleanup pass
alone; then SigProp and MagRef), with the passes spread over layers as
asked.

The CxtVLC tables are T.814's codeword tables (``c_q``, ``rho``,
``u_off``, ``e_k``, ``e_1``, codeword, length), packed one entry per
integer. They were transcribed from the two 1024-entry lookup tables of
the HT decoder in the OpenJPEG 2.5.4 that PIL bundles (which hold
T.814's tables indexed by context and the next seven bits), and the
lookup tables rebuilt from them equal OpenJPEG's entry for entry.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# (c_q << 23) | (rho << 19) | (u_off << 18) | (e_k << 14) | (e_1 << 10)
# | (codeword << 3) | length; the codeword's first bit is its LSB
TABLE0 = [  # the first quad row
    0x0080034, 0x00c45ff, 0x0100003, 0x0148bff, 0x018008d, 0x01c8aff,
    0x01cc4ff, 0x0200013, 0x025109e, 0x0280075, 0x02d111e, 0x02d447f,
    0x030001e, 0x034037f, 0x038017f, 0x03c806e, 0x03c8a7f, 0x0400023,
    0x04621ee, 0x04800ee, 0x04c016e, 0x050000d, 0x05621ae, 0x0568bbf,
    0x05801bf, 0x05c404e, 0x05c46bf, 0x06000f5, 0x06710ae, 0x067212e,
    0x06730bf, 0x068033f, 0x06c453f, 0x06d523f, 0x06f603f, 0x07003df,
    0x0748a5f, 0x076a02e, 0x07791df, 0x07802df, 0x07e64df, 0x07eeb5f,
    0x07f88ce, 0x07f9b9f, 0x07fc59f, 0x07fd14e, 0x07fd45f, 0x07fe1ce,
    0x07ff15f, 0x0800002, 0x0880074, 0x08c44ff, 0x0900034, 0x09489de,
    0x09800de, 0x09c01ee, 0x0a00054, 0x0a5115e, 0x0a8005e, 0x0ad119e,
    0x0ad47ff, 0x0b0009e, 0x0b4011e, 0x0b801ff, 0x0bc801e, 0x0bc8aff,
    0x0c00014, 0x0c620ee, 0x0c8016e, 0x0cc006e, 0x0d001ae, 0x0d620ae,
    0x0d68b7f, 0x0d8017f, 0x0dc408e, 0x0dc467f, 0x0e0000d, 0x0e6212e,
    0x0e7102e, 0x0e8007f, 0x0ec44bf, 0x0ed51ce, 0x0ef63bf, 0x0f001bf,
    0x0f48abf, 0x0f6a0ce, 0x0f7933f, 0x0f8003f, 0x0fe213f, 0x0fe884e,
    0x0fee14e, 0x0ff918e, 0x0ffc63f, 0x1000002, 0x1080074, 0x10c44de,
    0x1100034, 0x11489ff, 0x118015e, 0x11c459e, 0x11ccbff, 0x1200054,
    0x125105e, 0x128000d, 0x12d449e, 0x12d511e, 0x12d557f, 0x130001e,
    0x13402ff, 0x13800ff, 0x13c8b7f, 0x13cc48e, 0x13dd1bf, 0x1400014,
    0x146227f, 0x14801ee, 0x14c00ee, 0x150016e, 0x154006e, 0x158007f,
    0x15c81ae, 0x15c8bbf, 0x16000ae, 0x165112e, 0x16722bf, 0x16800bf,
    0x16e202e, 0x16f11ce, 0x16f473f, 0x170013f, 0x17480ce, 0x1748bdf,
    0x178023f, 0x17c444e, 0x17cc83f, 0x17dd18e, 0x17fc54e, 0x17fe1df,
    0x1800003, 0x1880024, 0x18c45ee, 0x1900065, 0x1948a7f, 0x19800ee,
    0x19c442e, 0x19ccbff, 0x1a000b5, 0x1a5116e, 0x1a80035, 0x1ad446e,
    0x1ad51ae, 0x1ad54d5, 0x1b001ff, 0x1b512ff, 0x1b588ff, 0x1b8037f,
    0x1bd90ae, 0x1bd997f, 0x1bdc52e, 0x1bdc87f, 0x1bdcfbf, 0x1c00055,
    0x1c6203f, 0x1c801ce, 0x1cc45bf, 0x1ce62bf, 0x1d000ce, 0x1d6214e,
    0x1d688bf, 0x1d8033f, 0x1dc463f, 0x1dcc84e, 0x1dec53f, 0x1dee3df,
    0x1e0018e, 0x1e5108e, 0x1e721df, 0x1e802df, 0x1ee64df, 0x1ef450e,
    0x1ef500e, 0x1ef555f, 0x1ef625f, 0x1ef735f, 0x1f0005f, 0x1f5109f,
    0x1f721f6, 0x1f7899f, 0x1f7939f, 0x1f8029f, 0x1fea876, 0x1fee71f,
    0x1ff991f, 0x1ffc4e5, 0x1ffc976, 0x1ffce1f, 0x1ffd015, 0x1ffd4f6,
    0x1ffe095, 0x1fff01f, 0x2000002, 0x2080074, 0x20c45ff, 0x2100034,
    0x21488de, 0x218015e, 0x21c89ee, 0x21cc7ff, 0x2200054, 0x22512ff,
    0x228005e, 0x22c019e, 0x230009e, 0x234011e, 0x23800ff, 0x23d001e,
    0x23d137f, 0x2400014, 0x24620ee, 0x248008e, 0x24c03bf, 0x250000d,
    0x256896e, 0x256a06e, 0x256a97f, 0x258027f, 0x25c01ae, 0x25ec87f,
    0x26000ae, 0x266212e, 0x26711bf, 0x26802bf, 0x26c402e, 0x26c443f,
    0x27000bf, 0x27511ce, 0x27720ce, 0x2778b3f, 0x278013f, 0x27dc84e,
    0x27ddbdf, 0x27e454e, 0x27e663f, 0x27ee18e, 0x27fd1df, 0x2800003,
    0x28800d5, 0x28c47ff, 0x2900055, 0x29488ee, 0x298016e, 0x29cc5ff,
    0x29cc9ce, 0x29cceff, 0x2a00095, 0x2a510ff, 0x2a8006e, 0x2ad11ae,
    0x2ad477f, 0x2b000ae, 0x2b4892e, 0x2b5917f, 0x2b8027f, 0x2bd902e,
    0x2bd9abf, 0x2bdc5bf, 0x2bdcbbf, 0x2bdcc7f, 0x2c00015, 0x2c620ce,
    0x2c80136, 0x2ce20bf, 0x2ce473f, 0x2d000e5, 0x2d6884e, 0x2d6a18e,
    0x2d6a94e, 0x2d8013f, 0x2de608e, 0x2de643f, 0x2dec7df, 0x2dec90e,
    0x2dece3f, 0x2e0000e, 0x2e621f6, 0x2e711df, 0x2e802df, 0x2ee60f6,
    0x2ee675f, 0x2ef455f, 0x2ef5176, 0x2ef54df, 0x2f0025f, 0x2f5985f,
    0x2f78876, 0x2f7929f, 0x2f7a1b6, 0x2f7a99f, 0x2f7b39f, 0x2f8009f,
    0x2fdd71f, 0x2fdd8b6, 0x2fdde1f, 0x2ff641f, 0x2ffc436, 0x2ffc825,
    0x2ffcfef, 0x2ffd065, 0x2ffe0a5, 0x2ffe9ef, 0x2fff11f, 0x3000003,
    0x3080024, 0x30c441e, 0x3100065, 0x314886e, 0x31800d5, 0x31cc4ee,
    0x31cc96e, 0x31ccdee, 0x3200055, 0x32511ff, 0x32801ae, 0x32c44ae,
    0x32d53ff, 0x330012e, 0x3348aff, 0x33590ff, 0x338037f, 0x33d902e,
    0x33d9a7f, 0x33dc5b6, 0x33dcbbf, 0x33dcd7f, 0x3400095, 0x346207f,
    0x34801ce, 0x34c45bf, 0x34e62bf, 0x35000ce, 0x354894e, 0x356a0bf,
    0x358033f, 0x35e444e, 0x35e663f, 0x35ec98e, 0x35ee3df, 0x35ee93f,
    0x360008e, 0x36711df, 0x367210e, 0x367303f, 0x36802df, 0x36d500e,
    0x36d559f, 0x36f20df, 0x36f475f, 0x370015f, 0x374885f, 0x3778a5f,
    0x377929f, 0x377a1f6, 0x377b39f, 0x378009f, 0x37d98f6, 0x37ee71f,
    0x37fa976, 0x37fc4e5, 0x37fc815, 0x37fcc76, 0x37fd136, 0x37fd51f,
    0x37fe036, 0x37ff0b6, 0x3800095, 0x388002e, 0x38c47ff, 0x39001ce,
    0x39489ff, 0x39802ff, 0x39cc57f, 0x39ccb7f, 0x39cccff, 0x3a0027f,
    0x3a5107f, 0x3a802bf, 0x3ac44ce, 0x3ad53bf, 0x3b001bf, 0x3b4014e,
    0x3b800bf, 0x3bd9b3f, 0x3bdc44e, 0x3bdca3f, 0x3bdcd3f, 0x3bdd03f,
    0x3bdd4df, 0x3c003df, 0x3c621df, 0x3c802df, 0x3cc018e, 0x3d0029f,
    0x3d4888e, 0x3d6a35f, 0x3d8015f, 0x3de665f, 0x3dec79f, 0x3dec90e,
    0x3decc5f, 0x3dee09f, 0x3dee99f, 0x3e0031f, 0x3e6211f, 0x3e7121f,
    0x3e8001f, 0x3ee67ef, 0x3ef440e, 0x3ef51f6, 0x3ef56ef, 0x3ef60ef,
    0x3ef71ef, 0x3f0036f, 0x3f5996f, 0x3f788f6, 0x3f793af, 0x3f7a076,
    0x3f7a86f, 0x3f7b26f, 0x3f800af, 0x3ffc404, 0x3ffc864, 0x3ffcc55,
    0x3ffd044, 0x3ffd4d5, 0x3ffd9b6, 0x3ffdeaf, 0x3ffe024, 0x3ffe576,
    0x3ffe815, 0x3ffed2f, 0x3fff0b6, 0x3fff5af, 0x3fffb2f, 0x3fffc35
]
TABLE1 = [  # the other quad rows
    0x0080003, 0x00c453e, 0x0100033, 0x01488be, 0x018006d, 0x01c01de,
    0x0200013, 0x025103e, 0x02800ad, 0x02c015e, 0x030000d, 0x03403ff,
    0x03800ff, 0x03c00de, 0x0400023, 0x046202d, 0x04800cd, 0x04c009e,
    0x050004d, 0x056205e, 0x05689ff, 0x05802ff, 0x05c019e, 0x060008d,
    0x066211e, 0x067137f, 0x068007f, 0x06c001e, 0x070017f, 0x07501ee,
    0x075127f, 0x07803bf, 0x07c40ee, 0x07c45bf, 0x0800001, 0x088002c,
    0x08c47ff, 0x090004c, 0x09488ff, 0x09800ed, 0x09c45ff, 0x09ccaff,
    0x0a0006d, 0x0a511bf, 0x0a8001e, 0x0ac037f, 0x0b0017f, 0x0b4027f,
    0x0b8007f, 0x0bc03bf, 0x0c0000c, 0x0c620bf, 0x0c8005e, 0x0cc02bf,
    0x0d0019e, 0x0d4033f, 0x0d8013f, 0x0dc015f, 0x0e0009e, 0x0e4023f,
    0x0e8003f, 0x0ec03df, 0x0f001df, 0x0f402df, 0x0f800df, 0x0fd011e,
    0x0fd135f, 0x1000001, 0x108004c, 0x10c47ff, 0x110000c, 0x114891e,
    0x11801ee, 0x11c89ff, 0x11cc4ff, 0x12000ad, 0x12512ff, 0x128001e,
    0x12c037f, 0x130017f, 0x134027f, 0x138007f, 0x13c00bf, 0x140002d,
    0x14623bf, 0x14801bf, 0x14c02bf, 0x15000ee, 0x156896e, 0x156a33f,
    0x156abdf, 0x158013f, 0x15c003f, 0x15eca3f, 0x160006e, 0x16401df,
    0x16802df, 0x16c00df, 0x170035f, 0x175025f, 0x175115f, 0x178005f,
    0x17d139f, 0x17d459f, 0x17dca9f, 0x17fe09f, 0x1800002, 0x1880054,
    0x18c445e, 0x1900014, 0x194891e, 0x1980075, 0x19cc49e, 0x19cc99e,
    0x19ccfff, 0x1a000b5, 0x1a511ff, 0x1a8001e, 0x1ac45ee, 0x1ad50ff,
    0x1b000ee, 0x1b402ff, 0x1b8016e, 0x1bd117f, 0x1bd44f6, 0x1bdcb7f,
    0x1c00035, 0x1c6227f, 0x1c8006e, 0x1cc01ae, 0x1d000ae, 0x1d4892e,
    0x1d6a07f, 0x1d8002e, 0x1de21ce, 0x1dec7bf, 0x1dec8ce, 0x1deccbf,
    0x1e0014e, 0x1e4004e, 0x1e801bf, 0x1ed018e, 0x1ed12bf, 0x1f0033f,
    0x1f5113f, 0x1f7223f, 0x1f78b5f, 0x1f8008e, 0x1fd983f, 0x1fdcfdf,
    0x1fea2df, 0x1ffc5f6, 0x1ffc90e, 0x1ffd15f, 0x1ffd4df, 0x1ffe00e,
    0x1ffe9df, 0x2000001, 0x208006d, 0x20c47ff, 0x21000ad, 0x21489ff,
    0x21802ff, 0x21c037f, 0x220004c, 0x225111e, 0x228019e, 0x22c00ff,
    0x230009e, 0x234017f, 0x238027f, 0x23c02bf, 0x240000c, 0x246207f,
    0x24803bf, 0x24c01bf, 0x25000ee, 0x25400bf, 0x258033f, 0x25c035f,
    0x260002d, 0x267103f, 0x267223f, 0x267313f, 0x26803df, 0x26c01df,
    0x27002df, 0x274801e, 0x27488df, 0x278015f, 0x27c465f, 0x27cc1ee,
    0x27cc85f, 0x2800002, 0x28800f5, 0x28c45de, 0x2900055, 0x29489ff,
    0x29800de, 0x29c005e, 0x2a00014, 0x2a5115e, 0x2a80075, 0x2ad119e,
    0x2ad47ff, 0x2b0009e, 0x2b4037f, 0x2b8011e, 0x2bc80ae, 0x2bc8aff,
    0x2c000b5, 0x2c6201e, 0x2c801ee, 0x2cc00ff, 0x2d000ee, 0x2d4016e,
    0x2d8006e, 0x2dc41ae, 0x2dc467f, 0x2e00035, 0x2e5112e, 0x2e7217f,
    0x2e8002e, 0x2ec47bf, 0x2ed51ce, 0x2ef607f, 0x2f000ce, 0x2f48abf,
    0x2f6a00e, 0x2f791bf, 0x2f800d5, 0x2fdd93f, 0x2fe64bf, 0x2ff573f,
    0x2ffc54e, 0x2ffc90e, 0x2ffcc3f, 0x2ffd18e, 0x2ffe08e, 0x2ffea3f,
    0x2fff04e, 0x3000003, 0x3080014, 0x30c441e, 0x3100064, 0x31489ee,
    0x31800ee, 0x31c886e, 0x31cc7ff, 0x3200024, 0x325116e, 0x3280055,
    0x32d11ae, 0x32d457f, 0x33000ae, 0x33489ff, 0x33592ff, 0x338012e,
    0x33c894e, 0x33cc4ff, 0x33dd37f, 0x34000b5, 0x346202e, 0x34801ce,
    0x34c00ce, 0x3500035, 0x356884e, 0x356a27f, 0x356a87f, 0x3580076,
    0x35c89bf, 0x35ea2bf, 0x35ec63f, 0x35ecbbf, 0x36000d5, 0x367113f,
    0x367233f, 0x36730bf, 0x368018e, 0x36d13df, 0x36f21df, 0x36f455f,
    0x36f503f, 0x370008e, 0x37510df, 0x377899f, 0x37792df, 0x377a10e,
    0x377ab5f, 0x378000e, 0x37cce5f, 0x37dd85f, 0x37ee69f, 0x37fc51f,
    0x37fc9f6, 0x37fd176, 0x37fd49f, 0x37fe0f6, 0x37feb9f, 0x37ff31f,
    0x3800024, 0x388019e, 0x38c449e, 0x390011e, 0x3948bff, 0x398001e,
    0x39c45ff, 0x39ccb7f, 0x3a0016e, 0x3a512ff, 0x3a800b5, 0x3ac45ee,
    0x3ad50ff, 0x3b000ee, 0x3b403bf, 0x3b80035, 0x3bd127f, 0x3bdc46e,
    0x3bdcabf, 0x3bdcc7f, 0x3bdd17f, 0x3c001ae, 0x3c621bf, 0x3c800ae,
    0x3cc013f, 0x3d0012e, 0x3d4014e, 0x3d800d5, 0x3dc473f, 0x3dcc82e,
    0x3dec4bf, 0x3dee3df, 0x3e001ce, 0x3e400ce, 0x3e80065, 0x3ec443f,
    0x3ed504e, 0x3ef463f, 0x3ef60df, 0x3f0018e, 0x3f48adf, 0x3f6a1f6,
    0x3f789df, 0x3f7905f, 0x3f80003, 0x3fdd90e, 0x3fee4f6, 0x3ffc415,
    0x3ffc855, 0x3ffcc8e, 0x3ffd0e5, 0x3ffd576, 0x3ffdd5f, 0x3ffe095,
    0x3ffe80e, 0x3ffee5f, 0x3fff076, 0x3ffff5f
]

MEL_EXP = (0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 5)


def unpack(entry: int) -> tuple[int, ...]:
    """(c_q, rho, u_off, e_k, e_1, codeword, length) of a table entry."""
    return (entry >> 23, (entry >> 19) & 15, (entry >> 18) & 1,
            (entry >> 14) & 15, (entry >> 10) & 15, (entry >> 3) & 127,
            entry & 7)


def _encoder_table(table):
    """(c_q, rho, u_off, emb) -> (codeword, length, e_k): for u_off = 1 the
    entry whose e_1 is emb masked by its e_k, with the most e_k bits."""
    out = {}
    ents = [unpack(e) for e in table]
    for cq in range(8):
        for rho in range(16):
            for ent in ents:
                if ent[:3] == (cq, rho, 0):
                    out[cq, rho, 0, 0] = (ent[5], ent[6], 0)
            for emb in range(1, 16):
                if emb & ~rho:
                    continue
                best = None
                for c, r, u, ek, e1, cwd, n in ents:
                    if (c, r, u) == (cq, rho, 1) and (emb & ek) == e1:
                        if best is None or bin(ek).count("1") >= \
                                bin(best[2]).count("1"):
                            best = (cwd, n, ek)
                if best is not None:
                    out[cq, rho, 1, emb] = best
    return out


_ENC = []


def _tables():
    if not _ENC:
        _ENC.extend([_encoder_table(TABLE0), _encoder_table(TABLE1)])
    return _ENC


# ------------------------------------------------------------ bit writers

class _Mel:
    """The MEL coder's bits, MSB first, 7 bits after a 0xFF byte."""

    def __init__(self):
        self.buf = bytearray()
        self.tmp, self.rem = 0, 8
        self.k, self.run = 0, 0

    def bit(self, v):
        self.tmp = (self.tmp << 1) | v
        self.rem -= 1
        if self.rem == 0:
            self.buf.append(self.tmp)
            self.rem = 7 if self.tmp == 0xFF else 8
            self.tmp = 0

    def encode(self, s):
        if not s:
            self.run += 1
            if self.run >= 1 << MEL_EXP[self.k]:
                self.bit(1)
                self.run = 0
                self.k = min(12, self.k + 1)
        else:
            self.bit(0)
            e = MEL_EXP[self.k]
            while e > 0:
                e -= 1
                self.bit((self.run >> e) & 1)
            self.run = 0
            self.k = max(0, self.k - 1)


class _Rev:
    """A backward stream (VLC, MagRef), LSB first: after a byte above
    0x8F a byte holds 7 bits when they are all ones, else 8."""

    def __init__(self, first=b"", tmp=0, used=0):
        self.buf = bytearray(first)  # in writing order (the stream reversed)
        self.tmp, self.used, self.last8f = tmp, used, True

    def put(self, cwd, n):
        while n > 0:
            avail = 8 - self.last8f - self.used
            t = min(avail, n)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used
            self.used += t
            avail -= t
            n -= t
            cwd >>= t
            if avail == 0:
                if self.last8f and self.tmp != 0x7F:
                    self.last8f = False
                    continue
                self.buf.append(self.tmp)
                self.last8f = self.tmp > 0x8F
                self.tmp, self.used = 0, 0


class _Fwd:
    """A forward stream (MagSgn, SigProp), LSB first, 7 bits after 0xFF."""

    def __init__(self):
        self.buf = bytearray()
        self.tmp, self.used, self.max = 0, 0, 8

    def put(self, cwd, n):
        while n > 0:
            t = min(self.max - self.used, n)
            self.tmp |= (cwd & ((1 << t) - 1)) << self.used
            self.used += t
            n -= t
            cwd >>= t
            if self.used == self.max:
                self.buf.append(self.tmp)
                self.max = 7 if self.tmp == 0xFF else 8
                self.tmp, self.used = 0, 0

    def magsgn_end(self) -> bytes:
        """MagSgn: the last byte padded with ones (a decoder reads 0xFF
        past the end), dropped where that makes it 0xFF."""
        if self.used:
            self.tmp |= ((1 << (self.max - self.used)) - 1) << self.used
            if self.tmp != 0xFF:
                self.buf.append(self.tmp)
        elif self.max == 7:
            self.buf.pop()
        return bytes(self.buf)

    def zero_end(self) -> bytes:
        if self.used:
            self.buf.append(self.tmp)
        return bytes(self.buf)


def _uvlc(u):
    """(prefix codeword, length, suffix, suffix length) of u >= 1."""
    if u == 1:
        return 1, 1, 0, 0
    if u == 2:
        return 2, 2, 0, 0
    if u <= 4:
        return 4, 3, u - 3, 1
    if u > 36:
        raise ValueError("U-VLC past 36 needs the extension")
    return 0, 3, u - 5, 5


# ---------------------------------------------------------- block coder

def cleanup(mu: np.ndarray, sign: np.ndarray) -> bytes:
    """The HT cleanup segment of magnitudes ``mu`` (the coefficients'
    magnitudes shifted down to the cleanup plane) and signs (1:
    negative) of one code-block."""
    h, w = mu.shape
    qh, qw = (h + 1) // 2, (w + 1) // 2
    pairs = (qw + 1) // 2
    W = pairs * 4 + 2
    m = np.zeros((qh * 2, W), np.int64)
    s = np.zeros((qh * 2, W), np.int64)
    m[:h, :w] = mu
    s[:h, :w] = sign
    E = np.zeros((qh * 2, W), np.int64)
    nz = m > 0
    E[nz] = [int(2 * v - 1).bit_length() for v in m[nz]]
    tab0, tab1 = _tables()
    # the VLC's first byte is Scup's high byte (a placeholder until the end),
    # its second holds Scup's low nibble under its first four bits
    mel, vlc, ms = _Mel(), _Rev(b"\xff", tmp=0xF, used=4), _Fwd()
    for qy in range(qh):
        y = 2 * qy
        first = qy == 0
        tab = tab0 if first else tab1
        prev_rho = 0
        for g in range(pairs):
            quads = []
            for k in range(2):
                x = 4 * g + 2 * k
                # samples TL, BL, TR, BR
                pos = [(y, x), (y + 1, x), (y, x + 1), (y + 1, x + 1)]
                rho = sum(1 << n for n, p in enumerate(pos) if m[p] > 0)
                es = [int(E[p]) for p in pos]
                emax = max(es)
                if first:
                    cq = ((prev_rho & 1) | ((prev_rho >> 1) & 1)) \
                        | ((prev_rho >> 2) & 1) << 1 \
                        | ((prev_rho >> 3) & 1) << 2
                    kappa = 1
                else:
                    def sig(yy, xx):
                        return int(xx >= 0 and m[yy, xx] > 0)
                    cq = (sig(y - 1, x - 1) | sig(y - 1, x)) \
                        | (sig(y, x - 1) | sig(y + 1, x - 1)) << 1 \
                        | (sig(y - 1, x + 1) | sig(y - 1, x + 2)) << 2
                    above = max(int(E[y - 1, xx]) for xx in
                                range(max(0, x - 1), x + 3))
                    gamma = bin(rho).count("1") > 1
                    kappa = max(1, above - 1) if gamma else 1
                uq = max(emax, kappa)
                u = uq - kappa
                emb = sum(1 << n for n in range(4) if es[n] == emax) \
                    if u > 0 else 0
                quads.append(dict(pos=pos, rho=rho, cq=cq, U=uq, u=u,
                                  emb=emb))
                prev_rho = rho
            if 4 * g + 2 >= w:  # a lone last quad: no partner is coded
                quads = quads[:1] + [dict(quads[1], u=0, skip=True)]
            for q in quads:
                if q.get("skip"):
                    continue
                if q["cq"] == 0:
                    mel.encode(q["rho"] != 0)
                if q["cq"] == 0 and q["rho"] == 0:
                    q["ek"] = 0
                    continue
                cwd, n, ek = tab[q["cq"], q["rho"], int(q["u"] > 0),
                                 q["emb"]]
                vlc.put(cwd, n)
                q["ek"] = ek
            u0, u1 = quads[0]["u"], quads[1]["u"]
            if first and u0 > 0 and u1 > 0:
                if u0 > 2 and u1 > 2:
                    mel.encode(1)
                    a, b = _uvlc(u0 - 2), _uvlc(u1 - 2)
                    vlc.put(a[0], a[1])
                    vlc.put(b[0], b[1])
                    vlc.put(a[2], a[3])
                    vlc.put(b[2], b[3])
                else:
                    mel.encode(0)
                    a = _uvlc(u0)
                    vlc.put(a[0], a[1])
                    if u0 > 2:
                        vlc.put(u1 - 1, 1)
                        vlc.put(a[2], a[3])
                    else:
                        b = _uvlc(u1)
                        vlc.put(b[0], b[1])
                        vlc.put(a[2], a[3])
                        vlc.put(b[2], b[3])
            elif u0 > 0 and u1 > 0:
                a, b = _uvlc(u0), _uvlc(u1)
                vlc.put(a[0], a[1])
                vlc.put(b[0], b[1])
                vlc.put(a[2], a[3])
                vlc.put(b[2], b[3])
            elif u0 > 0 or u1 > 0:
                a = _uvlc(max(u0, u1))
                vlc.put(a[0], a[1])
                vlc.put(a[2], a[3])
            for q in quads:
                if q.get("skip"):
                    continue
                for n, p in enumerate(q["pos"]):
                    if not (q["rho"] >> n) & 1:
                        continue
                    bits = q["U"] - ((q["ek"] >> n) & 1)
                    v = 2 * (int(m[p]) - 1) + int(s[p])
                    ms.put(v & ((1 << bits) - 1), bits)
    # MEL and VLC: the last partial bytes fused where they can be
    if mel.run > 0:
        mel.bit(1)
    mel_tmp = (mel.tmp << mel.rem) & 0xFF
    mel_mask = (0xFF << mel.rem) & 0xFF
    vlc_mask = 0xFF >> (8 - vlc.used)
    melb, vlcb = bytes(mel.buf), bytes(vlc.buf)
    if mel_mask | vlc_mask:
        fuse = mel_tmp | vlc.tmp
        if ((((fuse ^ mel_tmp) & mel_mask) | ((fuse ^ vlc.tmp) & vlc_mask))
                == 0 and fuse != 0xFF and len(vlcb) > 1):
            melb += bytes([fuse])
        else:
            melb += bytes([mel_tmp])
            vlcb += bytes([vlc.tmp])
    magsgn = ms.magsgn_end()
    tail = melb + vlcb[::-1]
    scup = len(tail)
    if scup < 2 or scup > 4079:
        raise ValueError(f"Scup {scup} out of range")
    seg = bytearray(magsgn + tail)
    seg[-1] = scup >> 4
    seg[-2] = (seg[-2] & 0xF0) | (scup & 15)
    return bytes(seg)


def refinement(q: np.ndarray, p: int, passes: int,
               causal: bool = False) -> tuple[bytes, bytes]:
    """The HT refinement segment of coefficients ``q`` whose cleanup pass
    coded bit planes ``p`` and up: SigProp for plane ``p - 1`` (4-row
    stripes, columns in groups of four: the significance bits of a
    group, then the signs of the samples that became significant), then
    MagRef (``passes == 3``) in a backward stream for the segment's end:
    (SigProp's bytes, MagRef's bytes in stream order)."""
    h, w = q.shape
    a = np.abs(q)
    sig = (a >> p) > 0
    new = np.zeros_like(sig)
    sp, mr = _Fwd(), _Rev()

    def known(yy, xx, y0):
        if not (0 <= yy < h and 0 <= xx < w):
            return False
        if sig[yy, xx]:
            return not (causal and yy >= y0 + 4)
        return bool(new[yy, xx])

    for y0 in range(0, h, 4):
        for x0 in range(0, w, 4):
            signs = []
            for x in range(x0, min(x0 + 4, w)):
                for y in range(y0, min(y0 + 4, h)):
                    if sig[y, x]:
                        continue
                    if any(known(y + dy, x + dx, y0)
                           for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                           if (dy, dx) != (0, 0)):
                        b = int((a[y, x] >> (p - 1)) & 1)
                        sp.put(b, 1)
                        if b:
                            new[y, x] = True
                            signs.append(int(q[y, x] < 0))
            for b in signs:
                sp.put(b, 1)
    out = sp.zero_end()
    mrb = b""
    if passes > 2:
        for y0 in range(0, h, 4):
            for x in range(w):
                for y in range(y0, min(y0 + 4, h)):
                    if sig[y, x]:
                        mr.put(int((a[y, x] >> (p - 1)) & 1), 1)
        if mr.used:
            mr.buf.append(mr.tmp)
        mrb = bytes(mr.buf[::-1])
    return out, mrb


# ------------------------------------------------------------ wavelets

def _refl(i, n):
    i = np.abs(i)
    return np.where(i >= n, 2 * (n - 1) - i, i)


def _fwd53(x, cas):
    """One level of the forward 5/3 along axis 0 of a line origin of
    parity ``cas``: low samples first, then high."""
    n = len(x)
    if n == 1:
        return x * 2 if cas else x.copy()
    idx = np.arange(n)
    hi, lo = idx[(idx + cas) % 2 == 1], idx[(idx + cas) % 2 == 0]
    y = x.copy()
    y[hi] = x[hi] - ((x[_refl(hi - 1, n)] + x[_refl(hi + 1, n)]) >> 1)
    y[lo] = x[lo] + ((y[_refl(lo - 1, n)] + y[_refl(lo + 1, n)] + 2) >> 2)
    return np.concatenate([y[lo], y[hi]])


_A, _B, _C, _D = -1.586134342, -0.052980118, 0.882911075, 0.443506852
_K, _KH = 1.230174104914001, 1.625732422


def _fwd97(x, cas):
    n = len(x)
    if n == 1:
        return x.copy()
    idx = np.arange(n)
    hi, lo = idx[(idx + cas) % 2 == 1], idx[(idx + cas) % 2 == 0]
    y = x.astype(np.float64).copy()
    for c, dst in ((_A, hi), (_B, lo), (_C, hi), (_D, lo)):
        y[dst] += c * (y[_refl(dst - 1, n)] + y[_refl(dst + 1, n)])
    return np.concatenate([y[lo] / _K, y[hi] / _KH])


def fdwt(a: np.ndarray, x0: int, y0: int, nl: int, rev: bool):
    """The forward DWT of a tile-component ``a`` at origin (x0, y0): each
    level its columns, then its rows, the low band top left (the layout
    in which a decoder reads the bands)."""
    a = a.astype(np.int64 if rev else np.float64).copy()
    f = _fwd53 if rev else _fwd97
    h, w = a.shape
    for lev in range(nl):
        rx0, ry0 = _cdiv(x0, 1 << lev), _cdiv(y0, 1 << lev)
        rw = _cdiv(x0 + w, 1 << lev) - rx0
        rh = _cdiv(y0 + h, 1 << lev) - ry0
        if rw == 0 or rh == 0:
            break
        r = a[:rh, :rw]
        r[:] = f(r, ry0 % 2)
        r[:] = f(r.T, rx0 % 2).T
    return a


def _cdiv(a, b):
    return -(-a // b)


# ------------------------------------------------------------ tier 2

class _Bio:
    """Packet header bits, MSB first; after 0xFF a byte holds 7 bits."""

    def __init__(self):
        self.out = bytearray()
        self.tmp, self.n, self.cap = 0, 0, 8

    def bit(self, b):
        self.tmp = (self.tmp << 1) | b
        self.n += 1
        if self.n == self.cap:
            self.out.append(self.tmp)
            self.cap = 7 if self.tmp == 0xFF else 8
            self.tmp, self.n = 0, 0

    def bits(self, v, n):
        for i in range(n - 1, -1, -1):
            self.bit((v >> i) & 1)

    def end(self) -> bytes:
        if self.n:
            self.out.append(self.tmp << (self.cap - self.n))
        if self.out and self.out[-1] == 0xFF:
            self.out.append(0)
        return bytes(self.out)


class _TagTree:
    def __init__(self, w, h, values):
        self.levels = []  # [values, lows, known] per level, leaves first
        vals = np.asarray(values, np.int64).reshape(h, w)
        while True:
            self.levels.append([vals, np.zeros_like(vals),
                                np.zeros(vals.shape, bool)])
            if vals.shape == (1, 1):
                break
            hh, ww = vals.shape
            nv = np.full(((hh + 1) // 2, (ww + 1) // 2), 1 << 30, np.int64)
            for y in range(hh):
                for x in range(ww):
                    nv[y // 2, x // 2] = min(nv[y // 2, x // 2], vals[y, x])
            vals = nv

    def encode(self, bio, x, y, threshold):
        path = []
        for lv in self.levels:
            path.append((lv, y, x))
            x, y = x // 2, y // 2
        low = 0
        for (vals, lows, known), yy, xx in reversed(path):
            if low > lows[yy, xx]:
                lows[yy, xx] = low
            else:
                low = int(lows[yy, xx])
            while low < threshold:
                if low >= vals[yy, xx]:
                    if not known[yy, xx]:
                        bio.bit(1)
                        known[yy, xx] = True
                    break
                bio.bit(0)
                low += 1
            lows[yy, xx] = low


def _numpasses(bio, n):
    if n == 1:
        bio.bit(0)
    elif n == 2:
        bio.bits(2, 2)
    elif n <= 5:
        bio.bits(3, 2)
        bio.bits(n - 3, 2)
    elif n <= 36:
        bio.bits(15, 4)
        bio.bits(n - 6, 5)
    else:
        bio.bits(511, 9)
        bio.bits(n - 37, 7)


@dataclass
class Cblk:
    """A code-block's passes: its bytes by pass (cleanup, SigProp, MagRef)
    and the layer each pass goes in; ``zbp`` the zero bit planes its
    header signals."""
    data: list
    layers: list
    zbp: int
    lblock: int = 3
    included: bool = False


@dataclass
class _Band:
    gw: int
    gh: int  # the code-block grid
    cblks: list = field(default_factory=list)  # Cblk or None, row-major
    incl: _TagTree | None = None
    imsb: _TagTree | None = None


def _packet(bands, layer) -> tuple[bytes, bytes]:
    """One packet: its header (tag trees, pass counts, Lblock, one length
    per codeword segment touched: the cleanup pass's, then the
    refinement passes') and its body."""
    bio = _Bio()
    body = bytearray()
    present = any(cb is not None and layer in cb.layers
                  for b in bands for cb in b.cblks)
    bio.bit(int(present))
    for b in bands if present else ():
        for k, cb in enumerate(b.cblks):
            x, y = k % b.gw, k // b.gw
            new = [] if cb is None else [
                i for i, lay in enumerate(cb.layers) if lay == layer]
            if cb is None or not cb.included:
                b.incl.encode(bio, x, y, layer + 1)
            else:
                bio.bit(int(bool(new)))
            if not new:
                continue
            if not cb.included:
                b.imsb.encode(bio, x, y, 999)
                cb.included = True
            _numpasses(bio, len(new))
            parts = []
            for seg in sorted({min(i, 1) for i in new}):
                ps = [i for i in new if min(i, 1) == seg]
                parts.append((len(ps), b"".join(cb.data[i] for i in ps)))
            inc = 0
            while any(len(d) >> (cb.lblock + inc + n.bit_length() - 1)
                      for n, d in parts):
                inc += 1
            bio.bits((1 << (inc + 1)) - 2, inc + 1)
            cb.lblock += inc
            for n, d in parts:
                bio.bits(len(d), cb.lblock + n.bit_length() - 1)
                body += d
    return bio.end(), bytes(body)


# ------------------------------------------------------------ codestream

def _gain(bandno):
    return (0, 1, 1, 2)[bandno]


def _bands(x0, y0, x1, y1, nl):
    """(resolution, bandno, (bx0, by0, bx1, by1), (ax, ay)): each band's
    coordinates and its offset in the DWT's layout, LL first."""
    out = []
    res = [(_cdiv(x0, 1 << (nl - r)), _cdiv(y0, 1 << (nl - r)),
            _cdiv(x1, 1 << (nl - r)), _cdiv(y1, 1 << (nl - r)))
           for r in range(nl + 1)]
    out.append((0, 0, res[0], (0, 0)))
    for r in range(1, nl + 1):
        lw, lh = res[r - 1][2] - res[r - 1][0], res[r - 1][3] - res[r - 1][1]
        nb = nl - r + 1
        for bandno in (1, 2, 3):
            ox = (1 << (nb - 1)) if bandno & 1 else 0
            oy = (1 << (nb - 1)) if bandno & 2 else 0
            box = (_cdiv(x0 - ox, 1 << nb), _cdiv(y0 - oy, 1 << nb),
                   _cdiv(x1 - ox, 1 << nb), _cdiv(y1 - oy, 1 << nb))
            out.append((r, bandno, box, (lw if bandno & 1 else 0,
                                         lh if bandno & 2 else 0)))
    return out


@dataclass
class Plan:
    """How the code-blocks are coded: ``plane(rng, mb, bits)`` gives a
    block's cleanup bit plane (``mb`` its band's magnitude bit planes,
    ``bits`` its largest magnitude's), ``passes(rng, p)`` its pass count
    (1 to 3; 1 where ``p`` is 0), ``layers(rng, passes, n)`` each pass's
    layer (non-decreasing, below ``n``)."""
    plane: object = None
    passes: object = None
    layers: object = None
    extra: int = 0  # empty passes signalled after the coded ones


def random_plan(max_passes=3, split=0.0):
    """Each block's cleanup plane below its largest magnitude's top, one
    to ``max_passes`` passes, the cleanup and SigProp in one layer and
    MagRef in that or a later one; with probability ``split`` each pass
    in a layer of its own draw (OpenJPEG 2.5 reads a refinement segment
    begun in a later layer than the cleanup into the cleanup's segment,
    and so fails or misreads the block: PIL's behaviour to hold the port
    to, not the standard's)."""
    def layers(rng, n, nl):
        if rng.random() < split:
            return sorted(int(v) for v in rng.integers(0, nl, n))
        first = int(rng.integers(0, nl))
        return ([first] * min(n, 2) + [int(rng.integers(first, nl))])[:n]
    return Plan(
        plane=lambda rng, mb, bits: int(rng.integers(0, max(1, min(
            mb, bits)))),
        passes=lambda rng, p: 1 if p == 0 else int(
            rng.integers(1, max_passes + 1)),
        layers=layers)


def encode(img: np.ndarray, *, prec=8, signed=False, rev=True, nl=2,
           cblk=(6, 6), causal=False, mct=None, tile=None,
           tile_origin=(0, 0), origin=(0, 0), nlayers=1, plan=None,
           seed=0, step_shift=0, sop_eph=False, roi=None) -> bytes:
    """A raw codestream of ``img`` ((h, w) or (h, w, C) integers of
    ``prec`` bits) with HT code-blocks: ``rev`` the 5/3 (else the 9/7 with
    step sizes 2^-``step_shift`` finer than each band's nominal), ``nl``
    decomposition levels, code-blocks 2^``cblk`` (x, y), ``causal`` the
    vertically causal SigProp, ``mct`` the RCT / ICT (default: three or
    more components), ``tile`` (w, h) tiles from ``tile_origin``, the
    image from ``origin``, ``nlayers`` layers, ``roi`` an RGN marker
    segment (component, shift) that changes no coefficient, ``sop_eph``
    SOP markers before the packets and EPH in the COD's style; ``plan``
    (default: every
    block's cleanup at plane 0, one pass, layer 0: lossless with the 5/3)
    draws each block's truncation from a generator seeded ``seed``."""
    img = np.asarray(img, np.int64)
    if img.ndim == 2:
        img = img[..., None]
    h, w, nc = img.shape
    mct = nc >= 3 if mct is None else mct
    plan = plan or Plan()
    rng = np.random.default_rng(seed)
    ox, oy = origin
    X1, Y1 = ox + w, oy + h
    tw, th = tile or (X1 - tile_origin[0], Y1 - tile_origin[1])
    tox, toy = tile_origin
    style = 0x40 | (8 if causal else 0)
    out = bytearray(b"\xff\x4f")
    siz = struct.pack(">HIIIIIIIIH", 0x4000, X1, Y1, ox, oy, tw, th, tox,
                      toy, nc)
    for _ in range(nc):
        siz += bytes([(0x80 if signed else 0) | (prec - 1), 1, 1])
    out += b"\xff\x51" + struct.pack(">H", 2 + len(siz)) + siz
    out += b"\xff\x50" + struct.pack(">HIH", 8, 0x00020000, 0)
    cod = struct.pack(">BBHBBBBBB", 6 if sop_eph else 0, 0, nlayers,
                      int(mct), nl, cblk[0] - 2, cblk[1] - 2, style,
                      int(rev))
    out += b"\xff\x52" + struct.pack(">H", 2 + len(cod)) + cod
    # step sizes: the nominal exponent prec + gain (plus step_shift on
    # the 9/7), mantissas drawn; the guard bits make room for the
    # largest coefficient of any tile
    nbands = 3 * nl + 1
    eps = [prec + _gain(0 if i == 0 else (i - 1) % 3 + 1) + (
        0 if rev else step_shift) for i in range(nbands)]
    mant = [0 if rev else int(rng.integers(0, 2048)) for _ in range(nbands)]
    tiles = []
    ntx, nty = _cdiv(X1 - tox, tw), _cdiv(Y1 - toy, th)
    need = [0] * nbands
    for t in range(ntx * nty):
        px, py = t % ntx, t // ntx
        tx0, ty0 = max(tox + px * tw, ox), max(toy + py * th, oy)
        tx1, ty1 = min(tox + (px + 1) * tw, X1), min(toy + (py + 1) * th, Y1)
        a = img[ty0 - oy:ty1 - oy, tx0 - ox:tx1 - ox].astype(
            np.int64 if rev else np.float64)
        if not signed:
            a = a - (1 << (prec - 1))
        if mct:
            r, g, b = a[..., 0], a[..., 1], a[..., 2]
            if rev:
                c3 = [(r + 2 * g + b) >> 2, b - g, r - g]
            else:
                c3 = [0.299 * r + 0.587 * g + 0.114 * b,
                      -0.16875 * r - 0.331260 * g + 0.5 * b,
                      0.5 * r - 0.41869 * g - 0.08131 * b]
            a = np.concatenate([np.stack(c3, -1), a[..., 3:]], -1)
        comps = []
        for c in range(nc):
            d = fdwt(a[..., c], tx0, ty0, nl, rev)
            bands = []
            for i, (r, bandno, box, (ax, ay)) in enumerate(
                    _bands(tx0, ty0, tx1, ty1, nl)):
                bw, bh = box[2] - box[0], box[3] - box[1]
                coef = d[ay:ay + bh, ax:ax + bw]
                if not rev:
                    stp = (1 + mant[i] / 2048) * 2.0 ** (prec - eps[i])
                    coef = np.trunc(coef / stp).astype(np.int64)
                if coef.size:
                    need[i] = max(need[i], int(np.abs(coef).max())
                                  .bit_length())
                bands.append((r, bandno, box, coef))
            comps.append(bands)
        tiles.append((tx0, ty0, tx1, ty1, comps))
    guard = max([1] + [need[i] - eps[i] + 1 for i in range(nbands)])
    if guard > 7:
        raise ValueError("coefficients too large for 7 guard bits")
    mb = [guard + e - 1 for e in eps]
    if rev:
        qcd = bytes([guard << 5]) + bytes(e << 3 for e in eps)
    else:
        qcd = bytes([(guard << 5) | 2]) + b"".join(
            struct.pack(">H", (e << 11) | m) for e, m in zip(eps, mant))
    out += b"\xff\x5c" + struct.pack(">H", 2 + len(qcd)) + qcd
    if roi:  # RGN: (component, shift), the shift signalled only
        out += b"\xff\x5e" + struct.pack(">HBBB", 5, roi[0], 0, roi[1])
    for t, (tx0, ty0, tx1, ty1, comps) in enumerate(tiles):
        # code-blocks, coded; their tag trees
        res = {}
        for c, bands in enumerate(comps):
            for i, (r, bandno, box, coef) in enumerate(bands):
                if box[0] >= box[2] or box[1] >= box[3]:
                    continue
                cw, ch = 1 << cblk[0], 1 << cblk[1]
                gx0, gy0 = box[0] // cw, box[1] // ch
                gw, gh = _cdiv(box[2], cw) - gx0, _cdiv(box[3], ch) - gy0
                band = _Band(gw, gh)
                for k in range(gw * gh):
                    x0 = max(box[0], (gx0 + k % gw) * cw)
                    y0 = max(box[1], (gy0 + k // gw) * ch)
                    x1 = min(box[2], (gx0 + k % gw + 1) * cw)
                    y1 = min(box[3], (gy0 + k // gw + 1) * ch)
                    q = coef[y0 - box[1]:y1 - box[1],
                             x0 - box[0]:x1 - box[0]]
                    band.cblks.append(_code(q, mb[i], plan, rng, nlayers,
                                            causal))
                band.incl = _TagTree(gw, gh, [
                    nlayers if cb is None else cb.layers[0]
                    for cb in band.cblks])
                band.imsb = _TagTree(gw, gh, [
                    0 if cb is None else cb.zbp for cb in band.cblks])
                res.setdefault((r, c), []).append(band)
        body = bytearray()
        npackets = 0
        nres = nl + 1
        for layer in range(nlayers):
            for r in range(nres):
                lev = 1 << (nl - r)
                if _cdiv(tx1, lev) == _cdiv(tx0, lev) or \
                        _cdiv(ty1, lev) == _cdiv(ty0, lev):
                    continue  # an empty resolution has no precinct
                for c in range(nc):
                    head, data = _packet(res.get((r, c), []), layer)
                    if sop_eph:
                        body += b"\xff\x91\x00\x04" + struct.pack(
                            ">H", npackets & 0xFFFF)
                        head += b"\xff\x92"
                    body += head + data
                    npackets += 1
        sot = struct.pack(">HIBB", t, 14 + len(body), 0, 1)
        out += b"\xff\x90" + struct.pack(">H", 10) + sot + b"\xff\x93" + body
    out += b"\xff\xd9"
    return bytes(out)


def _code(q, mb, plan, rng, nlayers, causal):
    """One code-block's Cblk under ``plan``, or None (nothing coded)."""
    bits = int(np.abs(q).max()).bit_length() if q.size else 0
    if bits == 0:
        return None
    p = plan.plane(rng, mb, bits) if plan.plane else 0
    p = min(p, bits - 1, mb - 1)
    passes = plan.passes(rng, p) if plan.passes and p > 0 else 1
    segs = cleanup(np.abs(q) >> p, (q < 0).astype(np.int64))
    data = [segs]
    if passes > 1:
        sp, mr = refinement(q, p, passes, causal)
        data += [sp, mr][:passes - 1]
    data += [b""] * plan.extra
    layers = (plan.layers(rng, len(data), nlayers) if plan.layers
              else [0] * len(data))
    return Cblk(data, layers, mb - 1 - p)
