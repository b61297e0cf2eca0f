"""Recognition evaluation: accuracy, edit distance, per-script breakdown
(the port's copy of ``fots/ocr_eval.py``).

Exact-match accuracy, total and per-character edit distance, per-script
(Latin / Arabic / CJK / Digit / ...) accuracy classified through
``unicodedata``, the gt-script x predicted-script confusion counts, a CSV
and an HTML worst-case report (optionally with crop thumbnails).  The same
arithmetic and formatting as ``fots``, so the same summaries and files.
"""

from __future__ import annotations

import unicodedata as ud
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from fots_torch.codec import levenshtein

_SCRIPT_PREFIXES = (
    ("LATIN", "Latin"),
    ("ARABIC", "Arabic"),
    ("CJK", "CJK"),
    ("HIRAGANA", "Japanese"),
    ("KATAKANA", "Japanese"),
    ("HANGUL", "Korean"),
    ("BENGALI", "Bangla"),
    ("DEVANAGARI", "Devanagari"),
    ("CYRILLIC", "Cyrillic"),
    ("GREEK", "Greek"),
    ("DIGIT", "Digit"),
)


def script_of(text: str) -> str:
    """Dominant script of a transcription (first letter-ish char wins)."""
    for ch in text:
        try:
            name = ud.name(ch)
        except ValueError:
            continue
        for prefix, script in _SCRIPT_PREFIXES:
            if prefix in name:
                return script
    return "Other"


@dataclass
class OCRMetrics:
    correct: int = 0
    total: int = 0
    edit_dist: int = 0
    gt_chars: int = 0
    per_script: Dict[str, List[int]] = field(default_factory=dict)  # [correct, total]
    worst: List[Tuple[int, str, str]] = field(default_factory=list)
    # gt-script -> predicted-script counts
    confusion: Dict[Tuple[str, str], int] = field(default_factory=dict)

    def add(self, pred: str, gt: str):
        ok = pred == gt
        d = levenshtein(pred, gt)
        self.correct += int(ok)
        self.total += 1
        self.edit_dist += d
        self.gt_chars += len(gt)
        s = script_of(gt)
        self.per_script.setdefault(s, [0, 0])
        self.per_script[s][0] += int(ok)
        self.per_script[s][1] += 1
        key = (s, script_of(pred))
        self.confusion[key] = self.confusion.get(key, 0) + 1
        if d > 0:
            self.worst.append((d, gt, pred))

    def summary(self) -> Dict:
        acc = self.correct / self.total if self.total else 0.0
        cer = self.edit_dist / self.gt_chars if self.gt_chars else 0.0
        return {
            "accuracy": acc,
            "total": self.total,
            "edit_distance": self.edit_dist,
            "cer": cer,
            "per_script": {
                k: {"accuracy": c / t if t else 0.0, "total": t}
                for k, (c, t) in sorted(self.per_script.items())
            },
        }

    def worst_cases(self, n: int = 20) -> List[Tuple[int, str, str]]:
        return sorted(self.worst, key=lambda x: -x[0])[:n]

    def confusion_matrix(self):
        """(scripts, [n,n] counts): rows = gt script, cols = predicted."""
        scripts = sorted({k for pair in self.confusion for k in pair})
        idx = {s: i for i, s in enumerate(scripts)}
        m = [[0] * len(scripts) for _ in scripts]
        for (g, p), c in self.confusion.items():
            m[idx[g]][idx[p]] = c
        return scripts, m

    def to_html(self, path: str, n_worst: int = 50,
                images: Dict[str, str] = None):
        """HTML report: summary, per-script table, worst predictions;
        ``images`` maps a gt text to an image path shown as its thumbnail."""
        import html as _html

        s = self.summary()
        rows = []
        for d, gt, pred in self.worst_cases(n_worst):
            img = ""
            if images and gt in images:
                img = f'<img src="{_html.escape(images[gt])}" height="32">'
            rows.append(
                f"<tr><td>{img}</td><td>{_html.escape(gt)}</td>"
                f"<td>{_html.escape(pred)}</td><td>{d}</td></tr>")
        script_rows = "".join(
            f"<tr><td>{_html.escape(k)}</td><td>{v['accuracy']:.4f}</td>"
            f"<td>{v['total']}</td></tr>"
            for k, v in s["per_script"].items())
        doc = f"""<!doctype html><html><head><meta charset="utf-8">
<title>recognition eval</title>
<style>table{{border-collapse:collapse}}td,th{{border:1px solid #999;padding:2px 8px}}</style>
</head><body>
<h2>Summary</h2>
<p>accuracy {s['accuracy']:.4f} &middot; total {s['total']} &middot;
edit distance {s['edit_distance']} &middot; CER {s['cer']:.4f}</p>
<h2>Per-script accuracy</h2>
<table><tr><th>script</th><th>accuracy</th><th>total</th></tr>{script_rows}</table>
<h2>Worst predictions</h2>
<table><tr><th>crop</th><th>gt</th><th>pred</th><th>edit dist</th></tr>
{''.join(rows)}</table>
</body></html>"""
        with open(path, "w") as f:
            f.write(doc)

    def to_csv(self, path: str):
        import csv

        s = self.summary()
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["script", "accuracy", "total"])
            w.writerow(["ALL", s["accuracy"], s["total"]])
            for k, v in s["per_script"].items():
                w.writerow([k, v["accuracy"], v["total"]])
            scripts, m = self.confusion_matrix()
            if scripts:
                w.writerow([])
                w.writerow(["confusion_gt\\pred"] + scripts)
                for name, row in zip(scripts, m):
                    w.writerow([name] + row)
