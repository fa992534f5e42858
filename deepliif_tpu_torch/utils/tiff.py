"""Minimal self-contained tiled TIFF/BigTIFF I/O: the port's own copy of
deepliif_tpu/utils/tiff.py (host code, no device work).

The reference writes pyramidal BigTIFFs via tifffile and reads WSIs via a
zarr view over tiled TIFF pages with a Bio-Formats (JVM) fallback for
pathology formats (reference util/__init__.py:559-691, 774-792). Neither
tifffile nor zarr nor a JVM is available in this environment, so this module
implements the needed subset directly:

  * write_pyramid_tiff: tiled (256px) BigTIFF, deflate-, JPEG- or
    JPEG-2000-compressed, RGB, with /2 /4 /8 reduced-resolution pyramid
    pages — the same layout as the reference's write_big_tiff_file;
  * TiledTiffReader: random-access region reads that decode only the tiles
    or strips intersecting the request — the WSI fast path (bounded memory).
    Supports the layouts real slides use: classic and BigTIFF, tile- and
    strip-organized pages, uncompressed / deflate / JPEG (incl. Aperio .svs
    abbreviated-JPEG tiles with a shared JPEGTables segment) / JPEG 2000
    (Aperio 33003/33005 and TIFF 34712, via PIL's openjpeg codec), RGB(A)
    and YCbCr-in-JPEG photometrics; Hamamatsu .ndpi specifics (SourceLens
    magnification tag, >4 GiB modulo-2^32 strip-offset reconstruction,
    zeroed-SOF JPEG dimension patching);
  * read_description / parse_magnification: objective magnification from
    Aperio ImageDescription ("AppMag = 40") or OME-XML NominalMagnification
    (the reference get_wsi_resolution, models/__init__.py:730-782).

PIL remains the fallback for non-TIFF files.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np

# TIFF tags
IMAGE_WIDTH = 256
IMAGE_LENGTH = 257
BITS_PER_SAMPLE = 258
COMPRESSION = 259          # 1 = none, 7 = JPEG, 8 = deflate
PHOTOMETRIC = 262          # 2 = RGB, 6 = YCbCr
STRIP_OFFSETS = 273
ROWS_PER_STRIP = 278
STRIP_BYTE_COUNTS = 279
SAMPLES_PER_PIXEL = 277
PLANAR_CONFIG = 284
TILE_WIDTH = 322
TILE_LENGTH = 323
TILE_OFFSETS = 324
TILE_BYTE_COUNTS = 325
JPEG_TABLES = 347
SOFTWARE = 305
NEW_SUBFILE_TYPE = 254
SAMPLE_FORMAT = 339
NDPI_FORMAT_FLAG = 65420   # Hamamatsu .ndpi marker tag
NDPI_SOURCE_LENS = 65421   # objective power (float; -1 macro, -2 map)

TYPE_BYTE = 1
TYPE_ASCII = 2
TYPE_SHORT = 3    # uint16
TYPE_LONG = 4     # uint32
TYPE_RATIONAL = 5
TYPE_UNDEFINED = 7
TYPE_SSHORT = 8
TYPE_SLONG = 9
TYPE_FLOAT = 11
TYPE_DOUBLE = 12
TYPE_LONG8 = 16   # uint64 (BigTIFF)

TILE = 256


def _tile_grid(h, w, tile=TILE, tile_h=None):
    """Tile counts (rows, cols); ``tile_h`` defaults to the (square)
    ``tile`` width but must be passed for producers with non-square
    tiles (Trestle)."""
    th = tile if tile_h is None else tile_h
    ty = (h + th - 1) // th
    tx = (w + tile - 1) // tile
    return ty, tx


def _inline_or_pointer(typ, values, pointer):
    """BigTIFF IFD value field: values whose byte size fits the 8-byte value
    field MUST be stored inline (readers assume this); otherwise use the
    out-of-line pointer."""
    fmt = {TYPE_SHORT: 'H', TYPE_LONG: 'I', TYPE_LONG8: 'Q'}[typ]
    size = struct.calcsize('<' + fmt) * len(values)
    if size <= 8:
        raw = struct.pack(f'<{len(values)}{fmt}', *values).ljust(8, b'\x00')
        return struct.unpack('<Q', raw)[0]
    return pointer


IMAGE_DESCRIPTION = 270


def merge_jpeg_tables(tables, tile_data):
    """Combine an abbreviated JPEG tile stream with the page's shared
    JPEGTables segment (TIFF tag 347; the Aperio .svs layout): the tables
    stream is SOI..tables..EOI, the tile is SOI..scan..EOI — insert the
    tables right after the tile's SOI."""
    if not tables or len(tables) < 4:
        return tile_data
    body = tables[2:]
    if body[-2:] == b'\xff\xd9':
        body = body[:-2]
    if tile_data[:2] != b'\xff\xd8':
        return tile_data
    return tile_data[:2] + body + tile_data[2:]


def patch_jpeg_sof(stream, h, w):
    """Rewrite zeroed SOF dimensions in a JPEG stream.

    Hamamatsu .ndpi images wider/taller than JPEG's 65535 limit are stored
    with 0 in the SOF frame header; the true strip dimensions live in the
    TIFF tags (Bio-Formats applies the same fix when the reference reads
    .ndpi, util/__init__.py:559-617). Returns the stream with the SOF
    height/width replaced by (h, w) when they are zero. Raises when a
    zeroed dimension cannot be patched because the true extent exceeds the
    16-bit SOF field (such strips need restart-marker splitting, which no
    codec here performs)."""
    if stream[:2] != b'\xff\xd8':
        return stream
    i = 2
    n = len(stream)
    while i + 4 <= n:
        if stream[i] != 0xFF:
            break
        marker = stream[i + 1]
        if marker in (0xD8, 0x01) or 0xD0 <= marker <= 0xD7:
            i += 2
            continue
        seg_len = struct.unpack('>H', stream[i + 2:i + 4])[0]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            # SOF frame header: [len][precision][height u16][width u16]...
            dh, dw = struct.unpack('>HH', stream[i + 5:i + 9])
            if dh == 0 or dw == 0:
                if (dh == 0 and h > 0xFFFF) or (dw == 0 and w > 0xFFFF):
                    raise ValueError(
                        f'NDPI JPEG strip of {w}x{h} px exceeds the 65535 '
                        'JPEG dimension limit (restart-marker-split strips '
                        'are unsupported; rescan or convert the slide)')
                return (stream[:i + 5] + struct.pack('>HH', dh or h, dw or w)
                        + stream[i + 9:])
            return stream
        if marker == 0xDA:   # start of scan — no SOF found before it
            break
        i += 2 + seg_len
    return stream


def _decode_block(data, page, h, w):
    """Decode one tile/strip payload to (h, w, spp) uint8."""
    comp = page['compression']
    spp = page['spp']
    if comp == 1:
        arr = np.frombuffer(data, np.uint8)
    elif comp in (8, 32946):  # deflate / old deflate
        arr = np.frombuffer(zlib.decompress(data), np.uint8)
    elif comp == 7:  # JPEG ('new-style'); PIL handles YCbCr->RGB
        from PIL import Image
        stream = merge_jpeg_tables(page.get('jpeg_tables'), data)
        if page.get('ndpi'):
            stream = patch_jpeg_sof(stream, h, w)
        img = Image.open(io.BytesIO(stream))
        out = np.asarray(img.convert('RGB') if spp == 3 else img)
        if out.ndim == 2:
            out = out[:, :, None]
        # JPEG streams carry their own dimensions (may be padded tiles)
        full = np.zeros((h, w, out.shape[2]), np.uint8)
        full[:min(h, out.shape[0]), :min(w, out.shape[1])] = \
            out[:h, :w]
        return full
    elif comp in (33003, 33004, 33005, 34712):
        # JPEG 2000: 34712 = standard TIFF JP2, 33003/33005 = Aperio .svs
        # YCbCr/RGB J2K tiles (raw codestreams or JP2 boxes — PIL's
        # openjpeg codec accepts both)
        from PIL import Image
        img = Image.open(io.BytesIO(data))
        out = np.asarray(img.convert('RGB') if spp == 3 else img)
        if out.ndim == 2:
            out = out[:, :, None]
        full = np.zeros((h, w, out.shape[2]), np.uint8)
        full[:min(h, out.shape[0]), :min(w, out.shape[1])] = out[:h, :w]
        return full
    else:
        raise ValueError(f'unsupported TIFF compression {comp} '
                         '(supported: none, deflate, JPEG, JPEG2000)')
    n = h * w * spp
    if arr.size < n:
        arr = np.concatenate([arr, np.zeros(n - arr.size, np.uint8)])
    return arr[:n].reshape(h, w, spp)


def make_ome_xml(size_x, size_y, channel_names=None, size_c=3,
                 pixel_type='uint8'):
    """Minimal OME-XML ImageDescription (the reference embeds OME metadata
    via tifffile/bioformats, util/__init__.py:793-914)."""
    channel_names = channel_names or []
    channels = ''.join(
        f'<Channel ID="Channel:0:{i}" Name="{nm}" SamplesPerPixel="1"/>'
        for i, nm in enumerate(channel_names))
    return (
        '<?xml version="1.0" encoding="UTF-8"?>'
        '<OME xmlns="http://www.openmicroscopy.org/Schemas/OME/2016-06">'
        '<Image ID="Image:0"><Pixels ID="Pixels:0" DimensionOrder="XYCZT" '
        f'Type="{pixel_type}" SizeX="{size_x}" SizeY="{size_y}" '
        f'SizeC="{max(size_c, len(channel_names) or 1)}" SizeZ="1" SizeT="1">'
        f'{channels}</Pixels></Image></OME>')


def write_pyramid_tiff(path, canvas, levels=(1, 2, 4, 8), tile=TILE,
                       compression=True, channel_names=None,
                       description=None, jpeg_quality=85, macro=None,
                       software=None):
    """Write an HxWx3 uint8 canvas as a pyramidal tiled BigTIFF.

    compression: True/'deflate' | 'jpeg' (per-tile standalone JPEG streams,
    the .svs tile layout) | False. ``description`` overrides the main
    page's ImageDescription (e.g. an Aperio-style 'AppMag = 40' string).

    ``macro`` optionally writes a small HxWx3 uint8 overview image as the
    FIRST page, ahead of the full-resolution pyramid — the Leica .scn /
    Ventana .bif layout (vendor slides the reference reads via
    Bio-Formats, util/__init__.py:559-617; TiledTiffReader selects the
    largest page as level 0, so such files read correctly).

    ``canvas`` may be a np.memmap: pages are sliced tile-by-tile, so the
    full-resolution image is never materialized in RAM.

    ``tile`` may be an int (square) or a (tile_w, tile_h) pair."""
    if not (isinstance(canvas, np.ndarray) and canvas.dtype == np.uint8
            and canvas.ndim == 3):
        canvas = np.ascontiguousarray(canvas, np.uint8)
    if canvas.ndim == 2:
        canvas = np.repeat(canvas[..., None], 3, -1)
    comp_jpeg = compression == 'jpeg'
    comp_j2k = compression == 'jpeg2000'
    pages = []
    main_idx = 0
    if macro is not None:
        pages.append(np.ascontiguousarray(macro, np.uint8))
        main_idx = 1
    for f in levels:
        if f == 1:
            pages.append(canvas)
        else:
            pages.append(canvas[::f, ::f])  # nearest decimation (fast)

    def encode_tile(t):
        if comp_jpeg or comp_j2k:
            from PIL import Image
            buf = io.BytesIO()
            if comp_j2k:
                # raw J2K codestreams per tile (the Aperio 33003/34712
                # layout); PIL uses openjpeg
                Image.fromarray(np.ascontiguousarray(t)).save(
                    buf, 'JPEG2000', codec='j2k')
            else:
                Image.fromarray(np.ascontiguousarray(t)).save(
                    buf, 'JPEG', quality=jpeg_quality)
            return buf.getvalue()
        raw = t.tobytes()
        return zlib.compress(raw, 6) if compression else raw

    with open(path, 'wb') as fh:
        # BigTIFF header
        fh.write(struct.pack('<2sHHHQ', b'II', 43, 8, 0, 0))
        header_next_ifd_pos = 8  # offset of the 'first IFD offset' field
        prev_next_field = header_next_ifd_pos

        tile_w, tile_h = (tile if isinstance(tile, (tuple, list))
                          else (tile, tile))
        for page_idx, img in enumerate(pages):
            h, w = img.shape[:2]
            ty, tx = _tile_grid(h, w, tile_w, tile_h)
            offsets, counts = [], []
            for j in range(ty):
                for i in range(tx):
                    t = img[j * tile_h:(j + 1) * tile_h,
                            i * tile_w:(i + 1) * tile_w]
                    if t.shape[0] != tile_h or t.shape[1] != tile_w:
                        pad = np.zeros((tile_h, tile_w, 3), np.uint8)
                        pad[:t.shape[0], :t.shape[1]] = t
                        t = pad
                    data = encode_tile(t)
                    offsets.append(fh.tell())
                    counts.append(len(data))
                    fh.write(data)

            # out-of-line arrays
            bps_off = fh.tell()
            fh.write(struct.pack('<3H', 8, 8, 8))
            off_arr_off = fh.tell()
            fh.write(struct.pack(f'<{len(offsets)}Q', *offsets))
            cnt_arr_off = fh.tell()
            fh.write(struct.pack(f'<{len(counts)}Q', *counts))
            desc_off = desc_len = 0
            if page_idx == main_idx and (channel_names or description):
                desc = (description.encode() if description
                        else make_ome_xml(w, h, channel_names).encode()) + b'\x00'
                desc_off = fh.tell()
                desc_len = len(desc)
                fh.write(desc)
            soft_off = soft_len = 0
            if page_idx == main_idx and software:
                soft = software.encode() + b'\x00'
                soft_off = fh.tell()
                soft_len = len(soft)
                fh.write(soft)

            entries = []

            def entry(tag, typ, count, value):
                entries.append((tag, typ, count, value))

            if page_idx > main_idx:
                entry(NEW_SUBFILE_TYPE, TYPE_LONG, 1, 1)
            if desc_len:
                entry(IMAGE_DESCRIPTION, 2, desc_len, desc_off)  # type ASCII
            if soft_len:
                entry(SOFTWARE, 2, soft_len, soft_off)           # type ASCII
            entry(IMAGE_WIDTH, TYPE_LONG, 1, w)
            entry(IMAGE_LENGTH, TYPE_LONG, 1, h)
            entry(BITS_PER_SAMPLE, TYPE_SHORT, 3,
                  _inline_or_pointer(TYPE_SHORT, (8, 8, 8), bps_off))
            entry(COMPRESSION, TYPE_SHORT, 1,
                  7 if comp_jpeg else (34712 if comp_j2k
                                       else (8 if compression else 1)))
            entry(PHOTOMETRIC, TYPE_SHORT, 1, 2)
            entry(SAMPLES_PER_PIXEL, TYPE_SHORT, 1, 3)
            entry(PLANAR_CONFIG, TYPE_SHORT, 1, 1)
            entry(TILE_WIDTH, TYPE_SHORT, 1, tile_w)
            entry(TILE_LENGTH, TYPE_SHORT, 1, tile_h)
            entry(TILE_OFFSETS, TYPE_LONG8, len(offsets),
                  _inline_or_pointer(TYPE_LONG8, offsets, off_arr_off))
            entry(TILE_BYTE_COUNTS, TYPE_LONG8, len(counts),
                  _inline_or_pointer(TYPE_LONG8, counts, cnt_arr_off))
            entries.sort()

            ifd_off = fh.tell()
            fh.write(struct.pack('<Q', len(entries)))
            for tag, typ, count, value in entries:
                fh.write(struct.pack('<HHQQ', tag, typ, count, value))
            next_field_pos = fh.tell()
            fh.write(struct.pack('<Q', 0))

            # patch previous next-IFD pointer
            end = fh.tell()
            fh.seek(prev_next_field)
            fh.write(struct.pack('<Q', ifd_off))
            fh.seek(end)
            prev_next_field = next_field_pos
    return path


def write_ome_multichannel_tiff(path, channels, channel_names=None,
                                tile=TILE, compression=True):
    """Write a (C, H, W) uint8 stack as a multichannel OME BigTIFF: one
    grayscale tiled page per channel + OME-XML on page 0 (the reference's
    write_ome_tiff_file, util/__init__.py:793-914 — 6-channel
    DAPI/Lap2/Marker/Seg/Pos/Neg stacks). Channels read back with
    TiledTiffReader.read_region(..., level=c)."""
    channels = np.ascontiguousarray(channels, np.uint8)
    if channels.ndim == 2:
        channels = channels[None]
    c_n, h, w = channels.shape
    channel_names = channel_names or [f'C{i}' for i in range(c_n)]

    with open(path, 'wb') as fh:
        fh.write(struct.pack('<2sHHHQ', b'II', 43, 8, 0, 0))
        prev_next_field = 8
        for ci in range(c_n):
            img = channels[ci]
            ty, tx = _tile_grid(h, w, tile)
            offsets, counts = [], []
            for j in range(ty):
                for i in range(tx):
                    t = img[j * tile:(j + 1) * tile, i * tile:(i + 1) * tile]
                    if t.shape != (tile, tile):
                        pad = np.zeros((tile, tile), np.uint8)
                        pad[:t.shape[0], :t.shape[1]] = t
                        t = pad
                    raw = t.tobytes()
                    data = zlib.compress(raw, 6) if compression else raw
                    offsets.append(fh.tell())
                    counts.append(len(data))
                    fh.write(data)
            off_arr_off = fh.tell()
            fh.write(struct.pack(f'<{len(offsets)}Q', *offsets))
            cnt_arr_off = fh.tell()
            fh.write(struct.pack(f'<{len(counts)}Q', *counts))
            desc_off = desc_len = 0
            if ci == 0:
                desc = make_ome_xml(w, h, channel_names,
                                    size_c=c_n).encode() + b'\x00'
                desc_off = fh.tell()
                desc_len = len(desc)
                fh.write(desc)

            entries = []
            if desc_len:
                entries.append((IMAGE_DESCRIPTION, TYPE_ASCII, desc_len,
                                desc_off))
            entries += [
                (IMAGE_WIDTH, TYPE_LONG, 1, w),
                (IMAGE_LENGTH, TYPE_LONG, 1, h),
                (BITS_PER_SAMPLE, TYPE_SHORT, 1, 8),
                (COMPRESSION, TYPE_SHORT, 1, 8 if compression else 1),
                (PHOTOMETRIC, TYPE_SHORT, 1, 1),   # min-is-black
                (SAMPLES_PER_PIXEL, TYPE_SHORT, 1, 1),
                (PLANAR_CONFIG, TYPE_SHORT, 1, 1),
                (TILE_WIDTH, TYPE_SHORT, 1, tile),
                (TILE_LENGTH, TYPE_SHORT, 1, tile),
                (TILE_OFFSETS, TYPE_LONG8, len(offsets),
                 _inline_or_pointer(TYPE_LONG8, offsets, off_arr_off)),
                (TILE_BYTE_COUNTS, TYPE_LONG8, len(counts),
                 _inline_or_pointer(TYPE_LONG8, counts, cnt_arr_off)),
            ]
            entries.sort()
            ifd_off = fh.tell()
            fh.write(struct.pack('<Q', len(entries)))
            for tag, typ, count, value in entries:
                fh.write(struct.pack('<HHQQ', tag, typ, count, value))
            next_field_pos = fh.tell()
            fh.write(struct.pack('<Q', 0))
            end = fh.tell()
            fh.seek(prev_next_field)
            fh.write(struct.pack('<Q', ifd_off))
            fh.seek(end)
            prev_next_field = next_field_pos
    return path


def parse_magnification(description):
    """Objective magnification from a slide ImageDescription string:
    Aperio 'AppMag = 40', OME-XML NominalMagnification, or a generic
    'Magnification' key (reference get_wsi_resolution reads this via
    Bio-Formats OME metadata, models/__init__.py:730-782)."""
    import re
    if not description:
        return None
    for pat in (r'AppMag\s*=\s*([0-9.]+)',
                r'NominalMagnification\s*=\s*"?([0-9.]+)',
                # Philips TIFF exports: DICOM attribute element in the
                # ImageDescription XML, e.g. <Attribute
                # Name="DICOM_OBJECTIVE_LENS_POWER" ...>"40"</Attribute>
                r'DICOM_OBJECTIVE_LENS_POWER[^>]*>\s*(?:&quot;|")?([0-9.]+)',
                r'Magnification\s*[=:]\s*"?([0-9.]+)',
                r'\|Mag\s*=\s*([0-9.]+)'):
        m = re.search(pat, description)
        if m:
            try:
                return float(m.group(1))
            except ValueError:
                continue
    # Leica .scn collection XML lists EVERY image's objective (the macro's
    # low-power one first) — the main image's is the highest
    objs = []
    for m in re.findall(r'<objective>\s*([0-9.]+)\s*</objective>',
                        description):
        try:
            objs.append(float(m))
        except ValueError:
            pass
    return max(objs) if objs else None


class TiledTiffReader:
    """Random-access reader for (Big)TIFFs with tiled RGB uint8 pages."""

    def __init__(self, path):
        self.path = path
        self.fh = open(path, 'rb')
        magic = self.fh.read(4)
        if magic[:2] != b'II':
            raise ValueError('only little-endian TIFF supported')
        version = struct.unpack('<H', magic[2:4])[0]
        if version == 43:
            self.big = True
            offsize, zero = struct.unpack('<HH', self.fh.read(4))
            self.first_ifd = struct.unpack('<Q', self.fh.read(8))[0]
        elif version == 42:
            self.big = False
            self.first_ifd = struct.unpack('<I', self.fh.read(4))[0]
        else:
            raise ValueError(f'not a TIFF file: {path}')
        self.pages = self._read_ifds()
        if not self.pages:
            raise ValueError('no TIFF pages found')
        # Level-0 page: the largest one. Aperio/OME/our own pyramids put
        # it first; Leica .scn and Ventana .bif store a macro/thumbnail
        # image AHEAD of the full-resolution pyramid. Ties keep the first
        # page (OME multichannel files address sibling planes by level).
        areas = [p['width'] * p['height'] for p in self.pages]
        self._base = max(range(len(self.pages)),
                         key=lambda i: (areas[i], -i))
        self._apply_trestle_overlaps()

    def _apply_trestle_overlaps(self):
        """Trestle (MedScan) TIFFs tile each pyramid level with
        overlapping tiles; the ImageDescription carries one ``x y``
        overlap pair per level after ``OverlapsXY=`` plus an optional
        hex ``Background Color=``. Effective level width shrinks by
        (tiles_across - 1) * overlap_x (openslide's published Trestle
        notes; the reference reads these through Bio-Formats,
        util/__init__.py:559-617). Pairs index pyramid levels from the
        full-resolution page on."""
        base = self.pages[self._base]
        desc = base.get('description') or ''
        if not str(base.get('software') or '').startswith('MedScan') \
                or 'OverlapsXY=' not in desc:
            return
        tail = desc.split('OverlapsXY=', 1)[1]
        nums = []
        for tok in tail.replace(';', ' ').split():
            if tok.lstrip('-').isdigit():
                nums.append(int(tok))
            else:
                break
        pairs = [(nums[i], nums[i + 1]) for i in range(0, len(nums) - 1, 2)]
        for lvl, pair in enumerate(pairs):
            if self._base + lvl < len(self.pages):
                self.pages[self._base + lvl]['overlap'] = pair
        if 'Background Color=' in desc:
            hexv = desc.split('Background Color=', 1)[1].strip()[:6]
            try:
                rgb = bytes.fromhex(hexv)
                for p in self.pages[self._base:]:
                    p['fill'] = tuple(rgb) if len(rgb) == 3 else 0
            except ValueError:
                pass

    @staticmethod
    def _effective_dims(page):
        """(width, height) with Trestle tile overlaps subtracted;
        identical to the raw page dims for every other producer."""
        w, h = page['width'], page['height']
        ox, oy = page.get('overlap', (0, 0))
        if (ox or oy) and page['tile_w']:
            ty, tx = _tile_grid(h, w, page['tile_w'],
                                page['tile_h'] or page['tile_w'])
            w -= (tx - 1) * ox
            h -= (ty - 1) * oy
        return w, h

    def _read_value_array(self, typ, count, raw):
        if typ in (TYPE_BYTE, TYPE_ASCII, TYPE_UNDEFINED):
            inline_cap = 8 if self.big else 4
            if count <= inline_cap:
                return bytes(raw[:count])
            off = struct.unpack('<Q' if self.big else '<I', raw[:inline_cap])[0]
            pos = self.fh.tell()
            self.fh.seek(off)
            data = self.fh.read(count)
            self.fh.seek(pos)
            return data
        if typ == TYPE_RATIONAL:
            pairs = self._read_value_array(TYPE_LONG, count * 2, raw)
            return tuple(n / d if d else 0.0
                         for n, d in zip(pairs[::2], pairs[1::2]))
        fmt = {TYPE_SHORT: 'H', TYPE_LONG: 'I', TYPE_LONG8: 'Q',
               TYPE_SSHORT: 'h', TYPE_SLONG: 'i', TYPE_FLOAT: 'f',
               TYPE_DOUBLE: 'd'}[typ]
        size = struct.calcsize('<' + fmt) * count
        inline_cap = 8 if self.big else 4
        if size <= inline_cap:
            return struct.unpack(f'<{count}{fmt}', raw[:size])
        off = struct.unpack('<Q' if self.big else '<I', raw[:inline_cap])[0]
        pos = self.fh.tell()
        self.fh.seek(off)
        vals = struct.unpack(f'<{count}{fmt}', self.fh.read(size))
        self.fh.seek(pos)
        return vals

    def _read_ifds(self):
        pages = []
        off = self.first_ifd
        while off:
            self.fh.seek(off)
            if self.big:
                n = struct.unpack('<Q', self.fh.read(8))[0]
                entry_size, count_fmt = 20, '<HHQ8s'
            else:
                n = struct.unpack('<H', self.fh.read(2))[0]
                entry_size, count_fmt = 12, '<HHI4s'
            raw = self.fh.read(entry_size * n)
            tags = {}
            for i in range(n):
                chunk = raw[i * entry_size:(i + 1) * entry_size]
                tag, typ, count, val = struct.unpack(count_fmt, chunk)
                tags[tag] = (typ, count, val)
            next_raw = self.fh.read(8 if self.big else 4)
            off = struct.unpack('<Q' if self.big else '<I', next_raw)[0]

            def get(tag, default=None):
                if tag not in tags:
                    return default
                typ, count, val = tags[tag]
                try:
                    return self._read_value_array(typ, count, val)
                except KeyError:   # unhandled TIFF value type
                    return default

            desc = get(IMAGE_DESCRIPTION)
            if isinstance(desc, bytes):
                desc = desc.rstrip(b'\x00').decode('utf-8', errors='replace')
            software = get(SOFTWARE)
            if isinstance(software, bytes):
                software = software.rstrip(b'\x00').decode(
                    'utf-8', errors='replace')
            page = {
                'width': get(IMAGE_WIDTH, (0,))[0],
                'height': get(IMAGE_LENGTH, (0,))[0],
                'tile_w': (get(TILE_WIDTH) or (None,))[0],
                'tile_h': (get(TILE_LENGTH) or (None,))[0],
                'compression': get(COMPRESSION, (1,))[0],
                'photometric': get(PHOTOMETRIC, (2,))[0],
                'spp': get(SAMPLES_PER_PIXEL, (1,))[0],
                'offsets': get(TILE_OFFSETS),
                'counts': get(TILE_BYTE_COUNTS),
                'strip_offsets': get(STRIP_OFFSETS),
                'strip_counts': get(STRIP_BYTE_COUNTS),
                'rows_per_strip': (get(ROWS_PER_STRIP) or (None,))[0],
                'jpeg_tables': get(JPEG_TABLES),
                'description': desc,
                'ndpi': NDPI_FORMAT_FLAG in tags,
                'source_lens': (get(NDPI_SOURCE_LENS) or (None,))[0],
                'software': software,
                'overlap': (0, 0),
                'fill': 0,
            }
            pages.append(page)
        self._fix_ndpi_offsets(pages)
        return pages

    def _fix_ndpi_offsets(self, pages):
        """Hamamatsu .ndpi files are classic TIFF even past 4 GiB: strip
        offsets are stored modulo 2**32. Image data is laid out in ascending
        file order, so the true offsets are recovered by carrying the high
        bits forward whenever a stored offset goes backwards (the same
        monotonic reconstruction Bio-Formats/tifffile apply; reference reads
        .ndpi via Bio-Formats, util/__init__.py:559-617)."""
        if self.big or not any(p['ndpi'] for p in pages):
            return
        import os
        file_size = os.fstat(self.fh.fileno()).st_size
        if file_size <= 0xFFFFFFFF:
            return
        prev = 0
        for page in pages:
            for key in ('offsets', 'strip_offsets'):
                arr = page[key]
                if not arr:
                    continue
                fixed = []
                for off in arr:
                    o64 = (prev & ~0xFFFFFFFF) | (off & 0xFFFFFFFF)
                    if o64 < prev:
                        o64 += 0x100000000
                    fixed.append(o64)
                    prev = o64
                page[key] = tuple(fixed)

    def get_magnification(self):
        """Objective magnification: Hamamatsu SourceLens tag (65421; the
        first positive value — macro/map pages store -1/-2), else the
        ImageDescription heuristics in parse_magnification over every page
        (vendors differ on which page carries the metadata)."""
        for page in self.pages:
            lens = page.get('source_lens')
            if lens is not None and lens > 0:
                return float(lens)
        # main page's description first: macro/thumbnail pages may carry
        # their own (lower) magnification metadata
        order = self.pages[self._base:] + self.pages[:self._base]
        for page in order:
            mag = parse_magnification(page.get('description'))
            if mag is not None:
                return mag
        return None

    def read_description(self, level=0):
        return self.pages[self._base + level].get('description')

    @property
    def size(self):
        return self._effective_dims(self.pages[self._base])

    def read_region(self, x, y, w, h, level=0):
        """Decode only the tiles/strips intersecting (x, y, w, h) on
        ``level`` (relative to the full-resolution page); returns
        (h, w, 3) uint8 (alpha dropped)."""
        page = self.pages[self._base + level]
        if page['tile_w'] is not None and page['offsets']:
            out = self._read_region_tiled(page, x, y, w, h)
        elif page['strip_offsets']:
            out = self._read_region_strips(page, x, y, w, h)
        else:
            raise ValueError('page has neither tiles nor strips')
        if out.shape[2] == 1:
            out = np.repeat(out, 3, axis=2)
        return out[:, :, :3]

    def _read_region_tiled(self, page, x, y, w, h):
        tw, th = page['tile_w'], page['tile_h']
        ox, oy = page.get('overlap', (0, 0))
        ax, ay = tw - ox, th - oy   # tile advance (== size unless Trestle)
        spp = 3 if page['compression'] == 7 else page['spp']
        ty, tx = _tile_grid(page['height'], page['width'], tw, th)
        ew, eh = self._effective_dims(page)
        out = np.zeros((h, w, spp), np.uint8)
        fill = page.get('fill', 0)
        if fill:
            out[:] = np.asarray(fill, np.uint8)[:spp]
        j0, j1 = y // ay, min((y + h - 1) // ay, ty - 1)
        i0, i1 = x // ax, min((x + w - 1) // ax, tx - 1)
        for j in range(j0, j1 + 1):
            for i in range(i0, i1 + 1):
                idx = j * tx + i
                self.fh.seek(page['offsets'][idx])
                data = self.fh.read(page['counts'][idx])
                tile = _decode_block(data, page, th, tw)
                ty0, tx0 = j * ay, i * ax
                # interior tiles expose only their advance-sized top-left
                # corner (the overlapped strip belongs to the next tile);
                # the last row/column keeps its full extent up to the
                # effective canvas edge
                vw = ax if i < tx - 1 else min(tw, ew - tx0)
                vh = ay if j < ty - 1 else min(th, eh - ty0)
                sy0, sx0 = max(y, ty0), max(x, tx0)
                sy1 = min(y + h, ty0 + vh)
                sx1 = min(x + w, tx0 + vw)
                if sy0 >= sy1 or sx0 >= sx1:
                    continue
                out[sy0 - y:sy1 - y, sx0 - x:sx1 - x] = \
                    tile[sy0 - ty0:sy1 - ty0, sx0 - tx0:sx1 - tx0, :spp]
        return out

    def _read_region_strips(self, page, x, y, w, h):
        rps = page['rows_per_strip'] or page['height']
        spp = 3 if page['compression'] == 7 else page['spp']
        width = page['width']
        out = np.zeros((h, w, spp), np.uint8)
        s0 = y // rps
        s1 = min((y + h - 1) // rps, len(page['strip_offsets']) - 1)
        for s in range(s0, s1 + 1):
            self.fh.seek(page['strip_offsets'][s])
            data = self.fh.read(page['strip_counts'][s])
            rows = min(rps, page['height'] - s * rps)
            strip = _decode_block(data, page, rows, width)
            sy0 = max(y, s * rps)
            sy1 = min(y + h, s * rps + rows)
            sx0, sx1 = max(x, 0), min(x + w, width)
            out[sy0 - y:sy1 - y, sx0 - x:sx1 - x] = \
                strip[sy0 - s * rps:sy1 - s * rps, sx0:sx1, :spp]
        return out

    def close(self):
        self.fh.close()
