"""Chunked, resumable HTTP downloader for prebuilt databases.

Behavior parity with the reference's async downloader
(foldcomp/setup.py:5-88): HEAD for size, skip when the full file already
exists, split files >10 MiB into byte-range chunks, resume partially
downloaded chunks via their on-disk size, retry dropped connections from the
current write position, then concatenate.

The port's own copy of `foldcomp_tpu/_setup_download.py:1`.
"""
from __future__ import annotations

import os

_CHUNK_THRESHOLD = 10 * 1024 * 1024
_BUFFER = 10 * 1024 * 1024


async def _remote_size(client, url) -> int:
    response = await client.head(url=url)
    if response.status_code != 200:
        return -1
    return int(response.headers["content-length"])


async def _download_range(client, url, start, end, output, mode):
    pos = start
    with open(output, mode) as f:
        # For a resumed chunk ("ab"), `start` was already advanced by the
        # pre-existing size and tell() starts at that size too — so the
        # chunk's original start is start - tell(), and the retry position
        # is that base plus however much the file now holds. (The reference
        # setup.py double-counts here and silently corrupts the resume.)
        base = pos - f.tell()
        while True:
            try:
                async with client.stream(
                        "GET", url,
                        headers={"Range": f"bytes={pos}-{end}"}) as response:
                    async for chunk in response.aiter_raw():
                        f.write(chunk)
            except Exception:
                # server closed the connection: resume from written position
                f.flush()
                os.fsync(f.fileno())
                pos = base + f.tell()
                if pos < end:
                    continue
            break


async def download(url: str, output: str, chunks: int = 16):
    import httpx
    async with httpx.AsyncClient(follow_redirects=True) as client:
        size = await _remote_size(client, url)
        if size == -1:
            return
        if os.path.exists(output) and os.path.getsize(output) == size:
            return

        ranges = []
        if size > _CHUNK_THRESHOLD:
            for i in range(chunks):
                start = i * size // chunks
                end = min((i + 1) * size // chunks, size) - 1
                part = f"{output}.{i}"
                mode = "wb"
                if os.path.exists(part):
                    start += os.path.getsize(part)
                    mode = "ab"
                if start < end:
                    ranges.append((start, end, part, mode))
        else:
            ranges.append((0, size, output, "wb"))

        import asyncio
        await asyncio.gather(
            *[_download_range(client, url, *r) for r in ranges])

        if len(ranges) == 1:
            return
        with open(output, "wb") as out:
            for _, _, part, _ in ranges:
                with open(part, "rb") as src:
                    while True:
                        buf = src.read(_BUFFER)
                        if not buf:
                            break
                        out.write(buf)
                os.remove(part)
