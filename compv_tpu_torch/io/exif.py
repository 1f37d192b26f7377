"""EXIF metadata extraction from JPEG files (host-side; mirror of
``compv_tpu/io/exif.py``, the same parse on the same bytes).

Reference: the CompV library vendors easyexif and exposes it via its file/IO
utility layer (SURVEY.md §2.1 "File/IO utils ... exif (easyexif)"). This is a
clean-room minimal JPEG/TIFF-IFD reader covering the same practical scope:
camera make/model, datetime, orientation, exposure, f-number, ISO, focal
length, pixel dimensions, and GPS position — the fields a vision pipeline
actually consumes (orientation for auto-rotate, focal length + sensor info
for calibration priors).

Pure stdlib; no dependency on PIL internals.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

__all__ = ["ExifData", "read_exif", "orientation_to_transform"]

# TIFF tag ids we care about (EXIF 2.3 / TIFF 6.0 public spec values)
_TAG_MAKE = 0x010F
_TAG_MODEL = 0x0110
_TAG_ORIENTATION = 0x0112
_TAG_DATETIME = 0x0132
_TAG_EXIF_IFD = 0x8769
_TAG_GPS_IFD = 0x8825
_TAG_EXPOSURE = 0x829A
_TAG_FNUMBER = 0x829D
_TAG_ISO = 0x8827
_TAG_DATETIME_ORIG = 0x9003
_TAG_FOCAL = 0x920A
_TAG_PIXEL_X = 0xA002
_TAG_PIXEL_Y = 0xA003
_TAG_FOCAL_35MM = 0xA405
_GPS_LAT_REF = 0x0001
_GPS_LAT = 0x0002
_GPS_LON_REF = 0x0003
_GPS_LON = 0x0004
_GPS_ALT = 0x0006

_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 7: 1, 9: 4, 10: 8}


@dataclass
class ExifData:
    make: str = ""
    model: str = ""
    datetime: str = ""
    datetime_original: str = ""
    orientation: int = 1          # TIFF orientation code 1..8
    exposure_time: float = 0.0    # seconds
    f_number: float = 0.0
    iso: int = 0
    focal_length_mm: float = 0.0
    focal_length_35mm: float = 0.0
    pixel_width: int = 0
    pixel_height: int = 0
    gps_latitude: float | None = None
    gps_longitude: float | None = None
    gps_altitude: float | None = None
    raw_tags: dict = field(default_factory=dict)


def _read_value(buf: bytes, off: int, typ: int, count: int, endian: str):
    size = _TYPE_SIZE.get(typ, 1) * count
    data = buf[off: off + size]
    if typ == 2:  # ASCII
        return data.split(b"\x00", 1)[0].decode("ascii", "replace")
    if typ in (1, 7):
        return list(data) if count > 1 else (data[0] if data else 0)
    if typ == 3:
        vals = struct.unpack(f"{endian}{count}H", data)
    elif typ == 4:
        vals = struct.unpack(f"{endian}{count}I", data)
    elif typ == 9:
        vals = struct.unpack(f"{endian}{count}i", data)
    elif typ == 5:  # unsigned rational
        raw = struct.unpack(f"{endian}{2 * count}I", data)
        vals = tuple(n / d if d else 0.0 for n, d in zip(raw[::2], raw[1::2]))
    elif typ == 10:  # signed rational
        raw = struct.unpack(f"{endian}{2 * count}i", data)
        vals = tuple(n / d if d else 0.0 for n, d in zip(raw[::2], raw[1::2]))
    else:
        return None
    return vals[0] if count == 1 else list(vals)


def _parse_ifd(tiff: bytes, ifd_off: int, endian: str) -> dict:
    """Parse one IFD into {tag: value}. Returns {} on any structural error."""
    tags = {}
    try:
        (n_entries,) = struct.unpack_from(f"{endian}H", tiff, ifd_off)
        for i in range(n_entries):
            e = ifd_off + 2 + 12 * i
            tag, typ, count = struct.unpack_from(f"{endian}HHI", tiff, e)
            size = _TYPE_SIZE.get(typ, 1) * count
            if size <= 4:
                val_off = e + 8
            else:
                (val_off,) = struct.unpack_from(f"{endian}I", tiff, e + 8)
            if val_off + size > len(tiff):
                continue
            val = _read_value(tiff, val_off, typ, count, endian)
            if val is not None:
                tags[tag] = val
    except struct.error:
        return tags
    return tags


def _dms_to_deg(dms, ref: str) -> float:
    if not isinstance(dms, list):
        dms = [dms]
    deg = sum(float(v) / (60.0 ** i) for i, v in enumerate(dms[:3]))
    return -deg if ref in ("S", "W") else deg


def parse_tiff(tiff: bytes) -> ExifData:
    """Parse a TIFF blob (the payload after the JPEG APP1 'Exif\\0\\0' header
    or a whole .tif file)."""
    out = ExifData()
    if len(tiff) < 8:
        return out
    endian = "<" if tiff[:2] == b"II" else ">"
    (ifd0_off,) = struct.unpack_from(f"{endian}I", tiff, 4)
    ifd0 = _parse_ifd(tiff, ifd0_off, endian)
    exif_ifd = (_parse_ifd(tiff, ifd0[_TAG_EXIF_IFD], endian)
                if isinstance(ifd0.get(_TAG_EXIF_IFD), int) else {})
    gps_ifd = (_parse_ifd(tiff, ifd0[_TAG_GPS_IFD], endian)
               if isinstance(ifd0.get(_TAG_GPS_IFD), int) else {})
    merged = {**ifd0, **exif_ifd}
    out.raw_tags = merged
    out.make = str(merged.get(_TAG_MAKE, "")).strip()
    out.model = str(merged.get(_TAG_MODEL, "")).strip()
    out.datetime = str(merged.get(_TAG_DATETIME, ""))
    out.datetime_original = str(merged.get(_TAG_DATETIME_ORIG, ""))
    out.orientation = int(merged.get(_TAG_ORIENTATION, 1) or 1)
    out.exposure_time = float(merged.get(_TAG_EXPOSURE, 0.0) or 0.0)
    out.f_number = float(merged.get(_TAG_FNUMBER, 0.0) or 0.0)
    out.iso = int(merged.get(_TAG_ISO, 0) or 0)
    out.focal_length_mm = float(merged.get(_TAG_FOCAL, 0.0) or 0.0)
    out.focal_length_35mm = float(merged.get(_TAG_FOCAL_35MM, 0.0) or 0.0)
    out.pixel_width = int(merged.get(_TAG_PIXEL_X, 0) or 0)
    out.pixel_height = int(merged.get(_TAG_PIXEL_Y, 0) or 0)
    if _GPS_LAT in gps_ifd and _GPS_LON in gps_ifd:
        out.gps_latitude = _dms_to_deg(gps_ifd[_GPS_LAT],
                                       str(gps_ifd.get(_GPS_LAT_REF, "N")))
        out.gps_longitude = _dms_to_deg(gps_ifd[_GPS_LON],
                                        str(gps_ifd.get(_GPS_LON_REF, "E")))
    if _GPS_ALT in gps_ifd:
        out.gps_altitude = float(gps_ifd[_GPS_ALT])
    return out


def read_exif(path: str) -> ExifData:
    """Extract EXIF from a JPEG (scans APP1) or TIFF file. Returns an
    ExifData with defaults when no metadata is present."""
    with open(path, "rb") as f:
        head = f.read(2)
        if head in (b"II", b"MM"):           # bare TIFF
            return parse_tiff(head + f.read())
        if head != b"\xff\xd8":              # not a JPEG
            return ExifData()
        while True:
            marker = f.read(2)
            if len(marker) < 2 or marker[0] != 0xFF:
                return ExifData()
            if marker[1] in (0xD8, 0x01) or 0xD0 <= marker[1] <= 0xD7:
                continue
            (seg_len,) = struct.unpack(">H", f.read(2))
            if marker[1] == 0xE1:            # APP1
                payload = f.read(seg_len - 2)
                if payload[:6] == b"Exif\x00\x00":
                    return parse_tiff(payload[6:])
            elif marker[1] == 0xDA:          # start of scan: no EXIF found
                return ExifData()
            else:
                f.seek(seg_len - 2, 1)


def orientation_to_transform(orientation: int):
    """Map a TIFF orientation code to (rot90_k, flip_horizontal) to apply to
    the decoded pixel array to display it upright:
    ``np.rot90(img, k)`` then optional ``img[:, ::-1]``."""
    table = {1: (0, False), 2: (0, True), 3: (2, False), 4: (2, True),
             5: (3, True), 6: (3, False), 7: (1, True), 8: (1, False)}
    return table.get(int(orientation), (0, False))
