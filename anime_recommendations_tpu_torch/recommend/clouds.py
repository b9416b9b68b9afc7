"""Word-cloud PNGs of a user's genre and source preferences.

Counterpart of anime_recommendations_tpu/recommend/clouds.py: the
``wordcloud`` package renders the cloud where it is installed; otherwise a
matplotlib layout (words scaled by count on a grid) makes the same
artifact, a PNG whose prominent words are the user's favorites. Both
packages are imported when a cloud is drawn, not with this module: a host
without matplotlib imports it, and have_matplotlib() tells the caller that
no PNG can be drawn there.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def have_matplotlib() -> bool:
    """True when matplotlib imports (every renderer needs it)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def render_cloud(
    frequencies: dict[str, int],
    path: str | Path,
    width: int = 600,
    height: int = 350,
    background: str = "white",
    colormap: str = "spring",
) -> str:
    """Render a frequency cloud PNG; returns the path written."""
    path = str(path)
    if not frequencies:
        frequencies = {"none": 1}
    try:
        from wordcloud import WordCloud
    except ImportError:
        return _matplotlib_cloud(frequencies, path, width, height, background, colormap)
    WordCloud(
        width=width,
        height=height,
        prefer_horizontal=0.85,
        background_color=background,
        contour_width=0.05,
        colormap=colormap,
    ).generate_from_frequencies(frequencies).to_file(path)
    return path


def _matplotlib_cloud(
    frequencies: dict[str, int],
    path: str,
    width: int,
    height: int,
    background: str,
    colormap: str,
) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    items = sorted(frequencies.items(), key=lambda kv: -kv[1])[:40]
    counts = np.asarray([c for _, c in items], dtype=np.float64)
    sizes = 10 + 28 * (counts / counts.max()) ** 0.5
    cmap = plt.get_cmap(colormap)
    rng = np.random.default_rng(0)

    fig = plt.figure(figsize=(width / 100, height / 100), dpi=100)
    ax = fig.add_axes([0, 0, 1, 1])
    ax.set_facecolor(background)
    fig.patch.set_facecolor(background)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    ax.axis("off")
    cols = max(int(np.ceil(np.sqrt(len(items)))), 1)
    for i, (word, _) in enumerate(items):
        x = (i % cols + 0.5) / cols + rng.uniform(-0.04, 0.04)
        y = 1.0 - (i // cols + 0.5) / cols + rng.uniform(-0.03, 0.03)
        ax.text(
            float(np.clip(x, 0.02, 0.98)),
            float(np.clip(y, 0.04, 0.96)),
            word,
            fontsize=float(sizes[i]),
            color=cmap(rng.random()),
            ha="center",
            va="center",
            rotation=0 if rng.random() < 0.85 else 90,
        )
    fig.savefig(path)
    plt.close(fig)
    return path


def genre_cloud(frequencies: dict[str, int], user_id: int,
                out_dir: str | Path = ".", width: int = 600, height: int = 350,
                fn: str = "favorite_genres.png") -> str:
    """User_ID_<id>_<fn>, white on the spring colormap."""
    path = Path(out_dir) / f"User_ID_{user_id}_{fn}"
    return render_cloud(frequencies, path, width, height, "white", "spring")


def source_cloud(frequencies: dict[str, int], user_id: int,
                 out_dir: str | Path = ".", width: int = 600, height: int = 350,
                 fn: str = "favorite_source_material.png") -> str:
    """User_ID_<id>_<fn>, gray on the autumn colormap."""
    path = Path(out_dir) / f"User_ID_{user_id}_{fn}"
    return render_cloud(frequencies, path, width, height, "gray", "autumn")
