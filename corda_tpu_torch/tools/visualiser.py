"""Network visualiser: render a simulation's message feed to SVG.

Capability match for the reference's network-visualiser (reference:
samples/network-visualiser/src/main/kotlin/net/corda/netmap/
NetworkMapVisualiser.kt — replays InMemoryMessagingNetwork.sentMessages as an
animated map). Headless variant: the same feed becomes a static SVG sequence
diagram (one lifeline per node, one arrow per message, topic-coloured), which
drops into any browser or doc. Zero rendering dependencies.

    from corda_tpu_torch.testing.simulation import TradeSimulation
    from corda_tpu_torch.tools.visualiser import render_svg
    sim = TradeSimulation(); sim.run_trade()
    render_svg(sim.sent_messages, "trade.svg")

The port's own copy of ``corda_tpu/tools/visualiser.py``. One feed
renders to the same bytes in both packages.
"""

from __future__ import annotations

from pathlib import Path

_COLORS = ("#4477AA", "#EE6677", "#228833", "#CCBB44", "#66CCEE", "#AA3377")


def _escape(text: str) -> str:
    return (text.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))


def render_svg(sent_messages, path: str | Path | None = None,
               max_messages: int = 400) -> str:
    """Sequence diagram of SentMessage records; returns the SVG text and
    optionally writes it to `path`."""
    messages = list(sent_messages)[:max_messages]
    nodes: list = []
    for m in messages:
        for endpoint in (m.sender, m.recipient):
            if endpoint not in nodes:
                nodes.append(endpoint)
    if not nodes:
        return "<svg xmlns='http://www.w3.org/2000/svg'/>"

    col_w, row_h, top = 180, 22, 60
    width = col_w * len(nodes) + 40
    height = top + row_h * (len(messages) + 1) + 40
    x_of = {n: 40 + col_w * i + col_w // 2 for i, n in enumerate(nodes)}
    topics = []
    parts = [
        f"<svg xmlns='http://www.w3.org/2000/svg' width='{width}' "
        f"height='{height}' font-family='monospace' font-size='11'>",
        "<rect width='100%' height='100%' fill='white'/>",
    ]
    for n in nodes:  # lifelines + headers
        x = x_of[n]
        parts.append(f"<line x1='{x}' y1='{top}' x2='{x}' "
                     f"y2='{height - 30}' stroke='#bbb'/>")
        parts.append(f"<text x='{x}' y='{top - 12}' text-anchor='middle' "
                     f"font-weight='bold'>{_escape(str(n))}</text>")
    for i, m in enumerate(messages):
        topic = m.message.topic_session.topic
        if topic not in topics:
            topics.append(topic)
        color = _COLORS[topics.index(topic) % len(_COLORS)]
        y = top + row_h * (i + 1)
        x1, x2 = x_of[m.sender], x_of[m.recipient]
        parts.append(f"<line x1='{x1}' y1='{y}' x2='{x2}' y2='{y}' "
                     f"stroke='{color}' marker-end='url(#arr)'/>")
        label_x = (x1 + x2) // 2
        parts.append(f"<text x='{label_x}' y='{y - 4}' text-anchor='middle' "
                     f"fill='{color}'>{_escape(topic)}</text>")
    parts.insert(1, "<defs><marker id='arr' markerWidth='8' markerHeight='8' "
                    "refX='7' refY='3' orient='auto'>"
                    "<path d='M0,0 L8,3 L0,6 z' fill='context-stroke'/>"
                    "</marker></defs>")
    parts.append("</svg>")
    svg = "\n".join(parts)
    if path is not None:
        Path(path).write_text(svg)
    return svg
