"""Character n-gram language identification (~72 languages).

The port's copy of the JAX package's `utils/language.py`, unchanged in
its tables and arithmetic (pure Python, f64 softmax), so the two packages
detect the same languages with the same confidences. It reads the port's
own copy of the profile file.

Reference parity: `core/.../utils/text/OptimaizeLanguageDetector.scala:45`
wraps the Optimaize fork of Cybozu language-detection, an n-gram-profile
classifier over ~70 languages. This is a from-scratch reimplementation of
the same technique (Cavnar-Trenkle rank-order trigram profiles + script
histograms). Profiles ship PRE-BUILT under
`transmogrifai_tpu_torch/resources/langid_profiles.json` (regenerate with
`build_profile_resource()`) and fall back to building from the embedded
seed text at import — the detector analogue of the reference packaging
its detector resources as a module; its outputs are held to the JAX
package's by tests/test_torch_language.py.

Three stages, cheapest first:

1. **Script histogram** — languages with a dedicated script (Greek, Thai,
   Hangul, Georgian, the Indic family, ...) are decided directly from
   codepoint ranges.
2. **Script-group disambiguation** — scripts shared by a few languages
   (Cyrillic, Arabic, Hebrew, Devanagari, Han/kana) are narrowed by
   distinctive-character evidence (e.g. Ukrainian і/ї/є/ґ, Persian
   پ/چ/ژ/گ, kana → Japanese).
3. **Trigram rank profiles** — Latin-script (and residual Cyrillic)
   languages are ranked by out-of-place distance between the text's
   trigram rank list and each language profile (Cavnar & Trenkle 1994),
   blended with a stopword-hit score for robustness on short inputs.

Returns ranked {language: confidence} like the reference's
`LanguageDetector.detectLanguages` contract.
"""

from __future__ import annotations

import json
import math
import os
import re
from collections import Counter
from typing import Dict, List, Optional, Tuple

import numpy as np

# --------------------------------------------------------------------- #
# script tables                                                         #
# --------------------------------------------------------------------- #

# dedicated scripts: range → ISO 639-1/3 code decided outright
_DEDICATED = [
    ((0x0370, 0x03FF), "el"), ((0x1F00, 0x1FFF), "el"),
    ((0x0530, 0x058F), "hy"),
    ((0x10A0, 0x10FF), "ka"),
    ((0x0E00, 0x0E7F), "th"), ((0x0E80, 0x0EFF), "lo"),
    ((0x1780, 0x17FF), "km"), ((0x1000, 0x109F), "my"),
    ((0x0980, 0x09FF), "bn"), ((0x0A00, 0x0A7F), "pa"),
    ((0x0A80, 0x0AFF), "gu"), ((0x0B00, 0x0B7F), "or"),
    ((0x0B80, 0x0BFF), "ta"), ((0x0C00, 0x0C7F), "te"),
    ((0x0C80, 0x0CFF), "kn"), ((0x0D00, 0x0D7F), "ml"),
    ((0x0D80, 0x0DFF), "si"),
    ((0x1200, 0x137F), "am"), ((0x0F00, 0x0FFF), "bo"),
    ((0xAC00, 0xD7AF), "ko"), ((0x1100, 0x11FF), "ko"),
]

# shared scripts: range → group name, disambiguated below
_GROUPS = [
    ((0x0400, 0x04FF), "cyrillic"),
    ((0x0600, 0x06FF), "arabic"), ((0x0750, 0x077F), "arabic"),
    ((0x0590, 0x05FF), "hebrew"),
    ((0x0900, 0x097F), "devanagari"),
    ((0x4E00, 0x9FFF), "han"), ((0x3400, 0x4DBF), "han"),
    ((0x3040, 0x309F), "kana"), ((0x30A0, 0x30FF), "kana"),
]

# distinctive characters inside shared scripts (presence is near-proof)
_CYR_MARKERS = {
    "uk": "іїєґ", "be": "ўі", "sr": "ђћџљњј", "mk": "ѓќѕџј",
    "bg": "",  # decided by elimination + trigrams
}
_ARABIC_FA = "پچژگ"
_ARABIC_UR = "ٹڈڑےھ"


def _script_of(cp: int) -> Optional[str]:
    for (lo, hi), name in _DEDICATED:
        if lo <= cp <= hi:
            return name
    for (lo, hi), name in _GROUPS:
        if lo <= cp <= hi:
            return name
    return None


# --------------------------------------------------------------------- #
# seed text → trigram rank profiles                                     #
# --------------------------------------------------------------------- #
# A few hundred characters of generic prose per language. Profiles are
# rank lists of the most frequent character trigrams (word-boundary
# padded), built once at import (~1 ms/language).

_SEED: Dict[str, str] = {
    "en": ("the quick brown fox jumps over the lazy dog while the weather "
           "in the northern regions has been cold and wet this year many "
           "people have decided that they would rather stay at home and "
           "read books about the history of their own country which is "
           "something that was not possible before the invention of "
           "printing and the spread of public education"),
    "de": ("der schnelle braune fuchs springt über den faulen hund während "
           "das wetter in den nördlichen regionen dieses jahr kalt und "
           "nass gewesen ist haben viele menschen beschlossen dass sie "
           "lieber zu hause bleiben und bücher über die geschichte ihres "
           "eigenen landes lesen was vor der erfindung des buchdrucks und "
           "der verbreitung der öffentlichen bildung nicht möglich war"),
    "fr": ("le renard brun rapide saute par dessus le chien paresseux "
           "alors que le temps dans les régions du nord a été froid et "
           "humide cette année beaucoup de gens ont décidé qu'ils "
           "préféraient rester chez eux et lire des livres sur l'histoire "
           "de leur propre pays ce qui n'était pas possible avant "
           "l'invention de l'imprimerie et la diffusion de l'éducation"),
    "es": ("el rápido zorro marrón salta sobre el perro perezoso mientras "
           "que el tiempo en las regiones del norte ha sido frío y húmedo "
           "este año mucha gente ha decidido que prefiere quedarse en "
           "casa y leer libros sobre la historia de su propio país algo "
           "que no era posible antes de la invención de la imprenta y la "
           "difusión de la educación pública"),
    "it": ("la rapida volpe marrone salta sopra il cane pigro mentre il "
           "tempo nelle regioni del nord è stato freddo e umido "
           "quest'anno molte persone hanno deciso che preferiscono "
           "rimanere a casa e leggere libri sulla storia del proprio "
           "paese cosa che non era possibile prima dell'invenzione della "
           "stampa e della diffusione dell'istruzione pubblica"),
    "pt": ("a rápida raposa marrom salta sobre o cão preguiçoso enquanto "
           "o tempo nas regiões do norte tem sido frio e úmido este ano "
           "muitas pessoas decidiram que preferem ficar em casa e ler "
           "livros sobre a história do seu próprio país algo que não era "
           "possível antes da invenção da imprensa e da difusão da "
           "educação pública"),
    "nl": ("de snelle bruine vos springt over de luie hond terwijl het "
           "weer in de noordelijke streken dit jaar koud en nat is "
           "geweest hebben veel mensen besloten dat zij liever thuis "
           "blijven en boeken lezen over de geschiedenis van hun eigen "
           "land iets dat niet mogelijk was voor de uitvinding van de "
           "boekdrukkunst en de verspreiding van het openbaar onderwijs"),
    "pl": ("szybki brązowy lis przeskakuje nad leniwym psem podczas gdy "
           "pogoda w północnych regionach była w tym roku zimna i mokra "
           "wielu ludzi zdecydowało że wolą zostać w domu i czytać "
           "książki o historii własnego kraju co nie było możliwe przed "
           "wynalezieniem druku i upowszechnieniem edukacji publicznej"),
    "cs": ("rychlá hnědá liška skáče přes líného psa zatímco počasí v "
           "severních oblastech bylo letos chladné a vlhké mnoho lidí se "
           "rozhodlo že raději zůstanou doma a budou číst knihy o "
           "historii své vlastní země což nebylo možné před vynálezem "
           "knihtisku a rozšířením veřejného vzdělávání"),
    "sk": ("rýchla hnedá líška skáče cez lenivého psa zatiaľ čo počasie v "
           "severných oblastiach bolo tento rok chladné a vlhké mnohí "
           "ľudia sa rozhodli že radšej zostanú doma a budú čítať knihy o "
           "histórii vlastnej krajiny čo nebolo možné pred vynálezom "
           "kníhtlače a rozšírením verejného vzdelávania"),
    "ro": ("vulpea maronie rapidă sare peste câinele leneș în timp ce "
           "vremea în regiunile nordice a fost rece și umedă anul acesta "
           "mulți oameni au decis că preferă să rămână acasă și să "
           "citească cărți despre istoria propriei lor țări ceva ce nu "
           "era posibil înainte de invenția tiparului și răspândirea "
           "educației publice"),
    "hu": ("a gyors barna róka átugrik a lusta kutya felett miközben az "
           "időjárás az északi régiókban hideg és nedves volt ebben az "
           "évben sok ember úgy döntött hogy inkább otthon marad és "
           "könyveket olvas saját országának történelméről ami nem volt "
           "lehetséges a könyvnyomtatás feltalálása és a közoktatás "
           "elterjedése előtt"),
    "fi": ("nopea ruskea kettu hyppää laiskan koiran yli kun taas sää "
           "pohjoisilla alueilla on ollut kylmä ja märkä tänä vuonna "
           "monet ihmiset ovat päättäneet että he mieluummin pysyvät "
           "kotona ja lukevat kirjoja oman maansa historiasta mikä ei "
           "ollut mahdollista ennen kirjapainotaidon keksimistä ja "
           "julkisen koulutuksen leviämistä"),
    "et": ("kiire pruun rebane hüppab üle laisa koera samal ajal kui ilm "
           "põhjapoolsetes piirkondades on sel aastal olnud külm ja märg "
           "paljud inimesed on otsustanud et nad jäävad pigem koju ja "
           "loevad raamatuid oma maa ajaloost mis ei olnud võimalik enne "
           "trükikunsti leiutamist ja hariduse levikut"),
    "sv": ("den snabba bruna räven hoppar över den lata hunden medan "
           "vädret i de norra regionerna har varit kallt och blött i år "
           "har många människor bestämt sig för att de hellre stannar "
           "hemma och läser böcker om sitt eget lands historia något som "
           "inte var möjligt före boktryckarkonstens uppfinning och den "
           "allmänna utbildningens spridning"),
    "da": ("den hurtige brune ræv hopper over den dovne hund mens vejret "
           "i de nordlige regioner har været koldt og vådt i år har "
           "mange mennesker besluttet at de hellere vil blive hjemme og "
           "læse bøger om deres eget lands historie noget der ikke var "
           "muligt før bogtrykkerkunstens opfindelse og udbredelsen af "
           "offentlig uddannelse"),
    "no": ("den raske brune reven hopper over den late hunden mens været "
           "i de nordlige områdene har vært kaldt og vått i år har mange "
           "mennesker bestemt seg for at de heller vil bli hjemme og "
           "lese bøker om sitt eget lands historie noe som ikke var "
           "mulig før boktrykkerkunsten ble oppfunnet og den offentlige "
           "utdanningen ble utbredt"),
    "tr": ("hızlı kahverengi tilki tembel köpeğin üzerinden atlar bu yıl "
           "kuzey bölgelerinde hava soğuk ve yağışlı olduğu için birçok "
           "insan evde kalmayı ve kendi ülkelerinin tarihi hakkında "
           "kitaplar okumayı tercih ettiklerine karar verdi bu matbaanın "
           "icadından ve halk eğitiminin yayılmasından önce mümkün "
           "değildi"),
    "vi": ("con cáo nâu nhanh nhẹn nhảy qua con chó lười biếng trong khi "
           "thời tiết ở các vùng phía bắc năm nay lạnh và ẩm ướt nhiều "
           "người đã quyết định rằng họ thích ở nhà và đọc sách về lịch "
           "sử của đất nước mình điều này không thể thực hiện được trước "
           "khi phát minh ra máy in và sự phổ biến của giáo dục công"),
    "id": ("rubah coklat yang cepat melompati anjing yang malas sementara "
           "cuaca di daerah utara tahun ini dingin dan basah banyak "
           "orang telah memutuskan bahwa mereka lebih suka tinggal di "
           "rumah dan membaca buku tentang sejarah negara mereka sendiri "
           "sesuatu yang tidak mungkin sebelum penemuan mesin cetak dan "
           "penyebaran pendidikan umum"),
    "ca": ("la ràpida guineu marró salta sobre el gos mandrós mentre que "
           "el temps a les regions del nord ha estat fred i humit aquest "
           "any molta gent ha decidit que prefereix quedar-se a casa i "
           "llegir llibres sobre la història del seu propi país cosa que "
           "no era possible abans de la invenció de la impremta i la "
           "difusió de l'educació pública"),
    "hr": ("brza smeđa lisica skače preko lijenog psa dok je vrijeme u "
           "sjevernim krajevima ove godine bilo hladno i mokro mnogi su "
           "ljudi odlučili da radije ostaju kod kuće i čitaju knjige o "
           "povijesti vlastite zemlje što nije bilo moguće prije izuma "
           "tiska i širenja javnog obrazovanja"),
    "sl": ("hitra rjava lisica skoči čez lenega psa medtem ko je bilo "
           "vreme v severnih krajih letos hladno in mokro so se mnogi "
           "ljudje odločili da raje ostanejo doma in berejo knjige o "
           "zgodovini svoje dežele kar ni bilo mogoče pred iznajdbo "
           "tiska in razširitvijo javnega izobraževanja"),
    "lt": ("greita ruda lapė šokinėja per tingų šunį o kadangi oras "
           "šiauriniuose regionuose šiais metais buvo šaltas ir drėgnas "
           "daugelis žmonių nusprendė kad jie mieliau lieka namuose ir "
           "skaito knygas apie savo šalies istoriją o tai nebuvo įmanoma "
           "iki spaudos išradimo ir viešojo švietimo paplitimo"),
    "lv": ("ātrā brūnā lapsa lec pāri slinkajam sunim kamēr laikapstākļi "
           "ziemeļu reģionos šogad ir bijuši auksti un mitri daudzi "
           "cilvēki ir nolēmuši ka viņi labprātāk paliek mājās un lasa "
           "grāmatas par savas valsts vēsturi kas nebija iespējams pirms "
           "iespiešanas izgudrošanas un izglītības izplatības"),
    "sq": ("dhelpra e shpejtë kafe kërcen mbi qenin dembel ndërsa moti në "
           "rajonet veriore këtë vit ka qenë i ftohtë dhe i lagësht "
           "shumë njerëz kanë vendosur që preferojnë të qëndrojnë në "
           "shtëpi dhe të lexojnë libra për historinë e vendit të tyre "
           "gjë që nuk ishte e mundur para shpikjes së shtypshkronjës"),
    "af": ("die vinnige bruin jakkals spring oor die lui hond terwyl die "
           "weer in die noordelike streke vanjaar koud en nat was het "
           "baie mense besluit dat hulle eerder tuis wil bly en boeke "
           "lees oor die geskiedenis van hul eie land iets wat nie "
           "moontlik was voor die uitvinding van die drukkuns en die "
           "verspreiding van openbare onderwys nie"),
    "sw": ("mbweha mwepesi wa kahawia anaruka juu ya mbwa mvivu wakati "
           "hali ya hewa katika mikoa ya kaskazini mwaka huu imekuwa "
           "baridi na mvua watu wengi wameamua kwamba wanapendelea "
           "kukaa nyumbani na kusoma vitabu kuhusu historia ya nchi yao "
           "jambo ambalo halikuwezekana kabla ya uvumbuzi wa uchapishaji "
           "na kuenea kwa elimu ya umma"),
    "tl": ("ang mabilis na kayumangging soro ay tumatalon sa ibabaw ng "
           "tamad na aso habang ang panahon sa hilagang mga rehiyon "
           "ngayong taon ay malamig at basa maraming tao ang nagpasya "
           "na mas gusto nilang manatili sa bahay at magbasa ng mga "
           "aklat tungkol sa kasaysayan ng kanilang sariling bansa "
           "bagay na hindi posible bago ang pag-imbento ng palimbagan"),
    "so": ("dawacada guduudan ee dhaqsaha badan ayaa ka boodda eyga "
           "caajiska ah iyadoo cimilada gobollada waqooyi sanadkan ay "
           "ahayd qabow iyo qoyaan dad badan ayaa go'aansaday inay "
           "doorbidaan inay guriga joogaan oo ay akhriyaan buugaag ku "
           "saabsan taariikhda dalkooda taasoo aan suurtogal ahayn ka "
           "hor hal-abuurka daabacaadda iyo faafinta waxbarashada"),
    "eu": ("azeri arre azkarra txakur alferraren gainetik jauzi egiten "
           "du aurten iparraldeko eskualdeetan eguraldia hotza eta "
           "hezea izan denez jende askok erabaki du nahiago duela "
           "etxean geratu eta bere herrialdearen historiari buruzko "
           "liburuak irakurri hori ezinezkoa zen inprenta asmatu eta "
           "hezkuntza publikoa zabaldu aurretik"),
    "ga": ("léimeann an sionnach donn tapa thar an madra leisciúil agus "
           "toisc go raibh an aimsir sna réigiúin thuaidh fuar agus "
           "fliuch i mbliana chinn go leor daoine gurbh fhearr leo "
           "fanacht sa bhaile agus leabhair a léamh faoi stair a dtíre "
           "féin rud nárbh fhéidir roimh aireagán an chló agus leathadh "
           "an oideachais phoiblí"),
    "gl": ("o rápido raposo marrón salta sobre o can preguiceiro "
           "mentres o tempo nas rexións do norte foi frío e húmido "
           "este ano moita xente decidiu que prefire quedar na casa e "
           "ler libros sobre a historia do seu propio país algo que "
           "non era posible antes da invención da imprenta e da "
           "difusión da educación pública"),
    "is": ("hinn snöggi brúni refur stekkur yfir lata hundinn en þar "
           "sem veðrið á norðurslóðum hefur verið kalt og blautt í ár "
           "hafa margir ákveðið að þeir vilji frekar vera heima og "
           "lesa bækur um sögu síns eigin lands nokkuð sem var ekki "
           "mögulegt fyrir uppfinningu prentlistarinnar og útbreiðslu "
           "almennrar menntunar"),
    "mt": ("il-volpi kannella mgħaġġla taqbeż fuq il-kelb għażżien "
           "filwaqt li t-temp fir-reġjuni tat-tramuntana din is-sena "
           "kien kiesaħ u mxarrab ħafna nies iddeċidew li jippreferu "
           "joqogħdu d-dar u jaqraw kotba dwar l-istorja ta' pajjiżhom "
           "ħaġa li ma kinitx possibbli qabel l-invenzjoni "
           "tal-istampar u t-tixrid tal-edukazzjoni pubblika"),
    "cy": ("mae'r llwynog brown cyflym yn neidio dros y ci diog ac "
           "oherwydd bod y tywydd yn y rhanbarthau gogleddol wedi bod "
           "yn oer ac yn wlyb eleni mae llawer o bobl wedi penderfynu "
           "y byddai'n well ganddynt aros gartref a darllen llyfrau am "
           "hanes eu gwlad eu hunain rhywbeth nad oedd yn bosibl cyn "
           "dyfeisio argraffu a lledaeniad addysg gyhoeddus"),
    "ms": ("musang coklat yang pantas melompat di atas anjing yang "
           "malas sementara cuaca di kawasan utara tahun ini sejuk dan "
           "lembap ramai orang telah memutuskan bahawa mereka lebih "
           "suka tinggal di rumah dan membaca buku mengenai sejarah "
           "negara mereka sendiri sesuatu yang tidak mungkin sebelum "
           "ciptaan mesin cetak dan penyebaran pendidikan awam"),
    "eo": ("la rapida bruna vulpo saltas super la mallaborema hundo dum "
           "la vetero en la nordaj regionoj ĉi-jare estis malvarma kaj "
           "malseka multaj homoj decidis ke ili preferas resti hejme "
           "kaj legi librojn pri la historio de sia propra lando io "
           "kio ne eblis antaŭ la invento de la presarto kaj la "
           "disvastiĝo de publika edukado"),
    # Devanagari-script profiles (used after script-group narrowing —
    # Hindi / Marathi / Nepali share the script, Optimaize separates
    # them by n-gram profile)
    "hi": ("तेज भूरी लोमड़ी आलसी कुत्ते के ऊपर से कूद जाती है जबकि इस "
           "वर्ष उत्तरी क्षेत्रों में मौसम ठंडा और गीला रहा है बहुत से "
           "लोगों ने निर्णय लिया है कि वे घर पर रहकर अपने देश के "
           "इतिहास के बारे में किताबें पढ़ना पसंद करते हैं जो छपाई के "
           "आविष्कार और सार्वजनिक शिक्षा के प्रसार से पहले संभव नहीं था "
           "बाजार में आज बहुत भीड़ थी और लोग सब्जियाँ फल और कपड़े खरीद "
           "रहे थे बच्चे स्कूल से लौटकर खेलने चले गए और शाम को पूरा "
           "परिवार एक साथ खाना खाने बैठा"),
    "mr": ("वेगवान तपकिरी कोल्हा आळशी कुत्र्यावरून उडी मारतो यावर्षी "
           "उत्तरेकडील प्रदेशात हवामान थंड आणि ओले असल्याने अनेक "
           "लोकांनी ठरवले आहे की त्यांना घरी राहून आपल्या देशाच्या "
           "इतिहासाबद्दल पुस्तके वाचायला आवडते जे छपाईच्या शोधापूर्वी "
           "आणि सार्वजनिक शिक्षणाच्या प्रसारापूर्वी शक्य नव्हते आज "
           "बाजारात खूप गर्दी होती आणि लोक भाज्या फळे आणि कपडे खरेदी "
           "करत होते मुले शाळेतून परत येऊन खेळायला गेली आणि "
           "संध्याकाळी संपूर्ण कुटुंब एकत्र जेवायला बसले"),
    "ne": ("छिटो खैरो फ्याउरो अल्छी कुकुरमाथि उफ्रन्छ यस वर्ष उत्तरी "
           "क्षेत्रहरूमा मौसम चिसो र भिजेको हुनाले धेरै मानिसहरूले "
           "घरमा बसेर आफ्नो देशको इतिहासका बारेमा किताबहरू पढ्न "
           "रुचाउने निर्णय गरेका छन् जुन छापाखानाको आविष्कार र "
           "सार्वजनिक शिक्षाको विस्तार अघि सम्भव थिएन आज बजारमा धेरै "
           "भीड थियो र मानिसहरू तरकारी फलफूल र लुगा किन्दै थिए "
           "केटाकेटीहरू विद्यालयबाट फर्केर खेल्न गए र बेलुका सारा "
           "परिवार सँगै खाना खान बस्यो"),
    # Cyrillic-script profiles (used after script-group narrowing)
    "ru": ("быстрая коричневая лиса перепрыгивает через ленивую собаку в "
           "то время как погода в северных районах в этом году была "
           "холодной и сырой многие люди решили что они предпочитают "
           "оставаться дома и читать книги об истории своей страны что "
           "было невозможно до изобретения книгопечатания и "
           "распространения народного образования"),
    "uk": ("швидка коричнева лисиця перестрибує через ледачого пса тоді "
           "як погода в північних районах цього року була холодною і "
           "вологою багато людей вирішили що вони воліють залишатися "
           "вдома і читати книжки про історію своєї країни що було "
           "неможливо до винайдення друкарства і поширення освіти"),
    "bg": ("бързата кафява лисица прескача мързеливото куче докато "
           "времето в северните райони тази година беше студено и "
           "влажно много хора решиха че предпочитат да си останат "
           "вкъщи и да четат книги за историята на собствената си "
           "страна нещо което не беше възможно преди изобретяването на "
           "печатарството и разпространението на образованието"),
    "sr": ("брза смеђа лисица скаче преко лењог пса док је време у "
           "северним крајевима ове године било хладно и влажно многи "
           "људи су одлучили да радије остају код куће и читају књиге о "
           "историји сопствене земље што није било могуће пре проналаска "
           "штампе и ширења јавног образовања"),
    "be": ("хуткая карычневая ліса пераскоквае праз лянівага сабаку ў "
           "той час як надворʼе ў паўночных раёнах сёлета было халодным "
           "і вільготным многія людзі вырашылі што яны аддаюць перавагу "
           "заставацца дома і чытаць кнігі пра гісторыю сваёй краіны"),
    "mk": ("брзата кафеава лисица прескокнува преку мрзливото куче "
           "додека времето во северните краишта оваа година беше студено "
           "и влажно многу луѓе одлучија дека претпочитаат да останат "
           "дома и да читаат книги за историјата на сопствената земја"),
}

# high-frequency function words per Latin language (blended with the
# trigram distance for robustness on very short inputs)
_STOPWORDS: Dict[str, frozenset] = {
    "en": frozenset("the of and to in is was for that it with as on be at "
                    "by this are but from they which not have his her".split()),
    "de": frozenset("der die und das den von zu mit sich des auf für ist im "
                    "dem nicht ein eine als auch es an werden aus".split()),
    "fr": frozenset("de la le et les des en un du une est que dans qui par "
                    "pour au sur pas plus ne se sont avec il".split()),
    "es": frozenset("de la que el en y a los se del las un por con una su "
                    "para es al lo como más pero sus le".split()),
    "it": frozenset("di e il la che in un a per è una sono con non del si "
                    "da come le dei nel alla più anche mi ai gli lo al "
                    "miei quel della".split()),
    "pt": frozenset("de a o que e do da em um para é com não uma os no se "
                    "na por mais as dos como mas foi ao".split()),
    "nl": frozenset("de van het een en in is dat op te zijn met voor niet "
                    "aan er om ook als dan maar bij uit".split()),
    "pl": frozenset("w i na z do się nie że jest przez od po jak za ale "
                    "co o tym był dla która które".split()),
    "cs": frozenset("a se v na je že o s z do k i za by ale jako po která "
                    "který pro jeho".split()),
    "sk": frozenset("a sa v na je že o s z do k i za by ale ako po ktorá "
                    "ktorý pre jeho čo".split()),
    "ro": frozenset("și de a în la cu pe care este un o nu din că mai să "
                    "se pentru au fost prin".split()),
    "hu": frozenset("a az és hogy nem is egy van volt meg ez de el már "
                    "csak mint ki mi még ha".split()),
    "fi": frozenset("ja on ei se että oli hän mutta ovat kun niin myös "
                    "jos kuin ole joka sen mitä".split()),
    "et": frozenset("ja on ei see et oli ta aga kui ka siis nagu oma välja "
                    "mis ning juba".split()),
    "sv": frozenset("och i att det som en på är av för med den till har "
                    "de inte om ett men var".split()),
    "da": frozenset("og i at det som en på er af for med den til har de "
                    "ikke om et men var der".split()),
    "no": frozenset("og i at det som en på er av for med den til har de "
                    "ikke om et men var seg".split()),
    "tr": frozenset("ve bir bu da de için ile olarak daha çok en gibi "
                    "kadar sonra ama ancak ise veya".split()),
    "vi": frozenset("và của là có trong được các một những người cho đã "
                    "không với này để khi về".split()),
    "id": frozenset("yang dan di dengan untuk dari pada dalam adalah ini "
                    "itu tidak akan telah oleh sebagai juga".split()),
    "ca": frozenset("de la i el que en a les un per amb una és al els no "
                    "del més ha com".split()),
    "hr": frozenset("je i u na se da su za od s a o kao ali iz bi koja "
                    "koji što".split()),
    "sl": frozenset("je in v na se da so za od z a o kot pa pri tudi ki "
                    "bi ni".split()),
    "lt": frozenset("ir yra į kad su iš tai bet kaip po už per apie buvo "
                    "jau tik".split()),
    "lv": frozenset("un ir uz ka ar no tas bet kā pēc par pie bija jau "
                    "tikai".split()),
    "sq": frozenset("dhe në një për me nga të që është si më por jo ka "
                    "kjo ky".split()),
    "af": frozenset("die en van is in dat het nie wat vir om te op sy "
                    "aan was hulle met".split()),
    "sw": frozenset("ya wa na ni kwa katika la za kuwa hii watu ambao "
                    "kama lakini pia yake".split()),
    "tl": frozenset("ang ng sa na mga ay at para hindi ito siya ko "
                    "niya kanyang may".split()),
    "so": frozenset("iyo ka ku ayaa in ay waa oo uu si aan badan waxa "
                    "lagu soo".split()),
    "eu": frozenset("eta da du bat ez zen dira ere dute egin izan den "
                    "baina hori".split()),
    "ga": frozenset("an na agus ar go sa atá le do is ní bhí sé mar "
                    "faoi ach".split()),
    "gl": frozenset("de a o que e do da en un para non unha os se na "
                    "por como máis".split()),
    "is": frozenset("og í að það sem er á af við um en hefur var ekki "
                    "til eru með".split()),
    "mt": frozenset("li ta u fil ma hija kien din dan għal biex fuq "
                    "mill lill".split()),
    "cy": frozenset("y yn a i o ar mae wedi bod gan am ei fod nad oedd "
                    "hefyd".split()),
    "ms": frozenset("yang dan di dengan untuk dari pada dalam adalah "
                    "ini itu tidak akan telah bahawa kerana boleh".split()),
    "eo": frozenset("la kaj de en estas al ne kiu por ke kun sed ili "
                    "tio pri".split()),
    "hi": frozenset("है के में की से पर यह और को ने का हैं था कि".split()),
    "mr": frozenset("आहे आणि च्या मध्ये ते हे या की आहेत होते केली".split()),
    "ne": frozenset("छ र को मा हरू छन् का लागि गरेको भएको पनि".split()),
    # Cyrillic function words strengthen the profile stage after the
    # distinctive-character checks fall through (short Serbian/Bulgarian
    # text without ђ/ћ/ј or ъ otherwise drifts to the Russian profile)
    "ru": frozenset("и в не на с как это он она они что был была по "
                    "к у же за из для весь".split()),
    "uk": frozenset("і в не на що він з як це до та але й у за".split()),
    "bg": frozenset("и в не на за да се от е като ще са по с който".split()),
    "sr": frozenset("је и у на се да су за од са као али што код ће "
                    "би них".split()),
    "be": frozenset("і ў не на я што ён з як гэта да але па".split()),
    "mk": frozenset("и на во да се од не ќе за е со кои што".split()),
}

# distinctive characters / digraphs per Latin-script language: strong
# short-text evidence the small trigram profiles can't supply (the same
# role Optimaize's per-language unigram frequency tables play)
_LATIN_MARKERS: Dict[str, Tuple[str, ...]] = {
    "en": ("th", "wh", "gh"),
    "de": ("ä", "ö", "ü", "ß", "sch", "ei"),
    "fr": ("ç", "è", "ê", "à", "ou", "eu", "qu"),
    "es": ("ñ", "¿", "¡", "ción", "ll"),
    "it": ("gli", "zz", "cch", "à", "ò", "ù"),
    "pt": ("ã", "õ", "ç", "ão", "nh", "lh"),
    "nl": ("ij", "aa", "ee", "oo", "uu", "sch"),
    "pl": ("ł", "ż", "ź", "ć", "ś", "ę", "ą", "ń", "sz", "cz"),
    "cs": ("ř", "ě", "ů", "ý", "ž", "š", "č"),
    "sk": ("ľ", "ĺ", "ŕ", "ô", "ä", "ž", "š", "č"),
    "ro": ("ă", "ș", "ț", "â", "î"),
    "hu": ("ő", "ű", "gy", "sz", "ly", "ö", "ü"),
    "fi": ("ää", "yy", "kk", "ssa", "lla", "en ", "ien"),
    "et": ("õ", "ää", "üü", "öö", "ja ", "ud "),
    "sv": ("å", "ä", "ö", "ck", "sj"),
    # da vs no hinges on function words and the Danish -ede past tense
    # (Norwegian uses -et/-te), af vs av, uden vs uten
    "da": ("æ", "ø", "å", "af ", "ede ", "uden", "jeg ", "hvad", "nogle"),
    "no": ("æ", "ø", "å", "av ", "uten", "øy", "hva ", "noen"),
    "tr": ("ğ", "ş", "ı", "ç", "ö", "ü"),
    "vi": ("ơ", "ư", "ạ", "ế", "ề", "ộ", "ậ", "ớ", "ờ", "ị", "ả", "ã",
           "ẻ", "ỏ", "ủ", "ỉ", "ẽ", "õ", "đ"),
    "id": ("ng", "ny", "kan", "ah ", "an "),
    "ca": ("ç", "l·l", "ny", "aix", "què", "à", "è"),
    "hr": ("ć", "đ", "ž", "š", "č", "ije"),
    "sl": ("č", "š", "ž", "nj", "lj"),
    "lt": ("ė", "ų", "į", "ū", "č", "š", "ž", "au"),
    "lv": ("ā", "ē", "ī", "ū", "ķ", "ļ", "ņ", "ģ"),
    "sq": ("ë", "ç", "xh", "sh", "që"),
    "af": ("nie ", " die ", " het ", " hulle "),
    "sw": (" ya ", " wa ", " kwa ", "ku", "wa"),
    "tl": (" ng ", " mga ", " ang ", " ay "),
    "so": ("aa", " oo ", " ayaa ", "dh", "x"),
    "eu": ("tz", "tx", " eta ", "ko ", "ak "),
    "ga": ("bh", "mh", "ch", " an ", " na ", "í"),
    "gl": ("x", " e ", "ción", " non ", " unha "),
    "is": ("ð", "þ", "æ", "ö"),
    "mt": ("ħ", "ġ", "ż", "għ", "x'"),
    "cy": ("dd", "ff", "wy", " y ", " yn ", "ch"),
    "ms": ("ng", "ny", "kan", "ah ", " bahawa ", " awam "),
    "eo": ("ĉ", "ĝ", "ŭ", "ĵ", "oj ", "as "),
    # Devanagari disambiguation: ळ and the -ांनी/-ीला case endings are
    # Marathi, the -हरू plural and छन् are Nepali, है/में and the ों
    # oblique plural + nukta ड़ are Hindi
    "hi": ("है", " के ", "में", "ने ", "ों", "ड़"),
    "mr": ("ळ", "आहे", "च्या", "ण", "ीला", "ांनी"),
    "ne": ("हरू", "छन्", "ेको", "छ "),
}

_PROFILE_SIZE = 400
_word_re = re.compile(r"[^\W\d_]+", re.UNICODE)


def _trigrams(text: str) -> Counter:
    """Word-padded character 2- and 3-grams (Cybozu/Optimaize use 1-3)."""
    grams: Counter = Counter()
    for w in _word_re.findall(text.lower()):
        padded = f" {w} "
        for i in range(len(padded) - 2):
            grams[padded[i:i + 3]] += 1
            grams[padded[i:i + 2]] += 1
        grams[padded[-2:]] += 1
    return grams


def _rank_profile(text: str) -> Dict[str, int]:
    return {g: r for r, (g, _) in
            enumerate(_trigrams(text).most_common(_PROFILE_SIZE))}


_PROFILES: Dict[str, Dict[str, int]] = {}

_PROFILE_RESOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "resources", "langid_profiles.json")


def _ensure_profiles() -> None:
    if _PROFILES:
        return
    try:  # packaged pre-built profiles (rank-ordered gram lists)
        with open(_PROFILE_RESOURCE, encoding="utf-8") as f:
            data = json.load(f)
        if isinstance(data, dict):
            for lang, grams in data.items():
                if isinstance(grams, list):
                    _PROFILES[lang] = {g: r for r, g in enumerate(grams)}
    except (OSError, ValueError):  # unreadable/corrupt → seed fallback
        pass
    for lang, seed in _SEED.items():  # fallback + newer-than-resource seeds
        if lang not in _PROFILES:
            _PROFILES[lang] = _rank_profile(seed)


def build_profile_resource(path: str = _PROFILE_RESOURCE) -> str:
    """(Re)generate the packaged profile file from the embedded seeds —
    run after adding or editing a language seed."""
    data = {}
    for lang, seed in sorted(_SEED.items()):
        prof = _rank_profile(seed)
        data[lang] = [g for g, _ in sorted(prof.items(), key=lambda kv: kv[1])]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, ensure_ascii=False)
    return path


# every profile's ranks as one table: a gram's row holds its rank in each
# language's profile (-1 where absent), the last row is all -1
_RANK_TABLE: Dict[str, object] = {}


def _rank_table():
    if not _RANK_TABLE:
        _ensure_profiles()
        langs = list(_PROFILES)
        grams = sorted({g for prof in _PROFILES.values() for g in prof})
        row = {g: i for i, g in enumerate(grams)}
        ranks = np.full((len(grams) + 1, len(langs)), -1, dtype=np.int64)
        for j, lang in enumerate(langs):
            for g, r in _PROFILES[lang].items():
                ranks[row[g], j] = r
        _RANK_TABLE.update(
            col={lang: j for j, lang in enumerate(langs)}, row=row,
            ranks=ranks, oop=np.array([len(_PROFILES[lang]) or _PROFILE_SIZE
                                       for lang in langs], dtype=np.int64))
    return _RANK_TABLE


def _rank_distances(text_ranks: List[str]) -> Optional[np.ndarray]:
    """The Cavnar-Trenkle out-of-place distance of the text's ranked
    grams to every profile (`_rank_table` column order), normalized to
    [0, 1]; None for no grams. Each gram adds |rank − its rank in the
    profile|, or the profile's size where it is absent, and the sum is
    divided by (grams × size). The sums are integers, exact in any order,
    so the distances are the JAX package's loop's floats."""
    if not text_ranks:
        return None
    tab = _rank_table()
    absent = len(tab["row"])
    prof = tab["ranks"][[tab["row"].get(g, absent) for g in text_ranks]]
    r = np.arange(len(text_ranks), dtype=np.int64)[:, None]
    oop = tab["oop"]
    total = np.where(prof >= 0, np.abs(r - prof), oop[None, :]).sum(0)
    return total.astype(np.float64) / (len(text_ranks) * oop)


def _score_profiles(text: str, candidates: List[str]) -> Dict[str, float]:
    """Blend trigram rank distance with stopword hits → {lang: score}."""
    _ensure_profiles()
    grams = _trigrams(text)
    text_ranks = [g for g, _ in grams.most_common(_PROFILE_SIZE)]
    dist = _rank_distances(text_ranks)
    col = _rank_table()["col"]
    words = _word_re.findall(text.lower())
    scores: Dict[str, float] = {}
    lo = text.lower()
    n_chars = max(len(lo), 1)
    for lang in candidates:
        prof = _PROFILES.get(lang)
        if prof is None:
            continue
        sim = 1.0 - (1.0 if dist is None else float(dist[col[lang]]))
        if words and lang in _STOPWORDS:
            hits = sum(1 for w in words if w in _STOPWORDS[lang])
            sim += 1.2 * hits / len(words)
        marks = _LATIN_MARKERS.get(lang)
        if marks:
            mhits = sum(lo.count(m) for m in marks)
            sim += 3.0 * min(mhits / n_chars, 0.1)
        scores[lang] = sim
    return scores


def _softmax_top(scores: Dict[str, float], temp: float = 0.05,
                 n_words: int = 100) -> Dict[str, float]:
    """Relative softmax over profile scores, damped by evidence volume —
    a one-word input can top the ranking but must not look certain
    (the reference's detector likewise returns low confidence on short
    strings, and TextTokenizer's 0.99 threshold then falls back to the
    default language)."""
    if not scores:
        return {}
    mx = max(scores.values())
    exp = {k: math.exp((v - mx) / temp) for k, v in scores.items()}
    z = sum(exp.values())
    damp = 1.0 - math.exp(-n_words / 4.0)
    ranked = sorted(exp.items(), key=lambda kv: -kv[1])
    return {k: damp * v / z for k, v in ranked[:3]}


_CYRILLIC_LANGS = ["ru", "uk", "bg", "sr", "be", "mk"]
_DEVANAGARI_LANGS = ["hi", "mr", "ne"]
_LATIN_LANGS = [l for l in _SEED
                if l not in _CYRILLIC_LANGS + _DEVANAGARI_LANGS]


def detect_language(text: Optional[str]) -> Dict[str, float]:
    """Ranked {language: confidence}; empty dict when undecidable."""
    if not text:
        return {}
    script_counts: Counter = Counter()
    latin = 0
    for ch in text:
        cp = ord(ch)
        if cp < 0x250 and ch.isalpha():
            latin += 1
            continue
        s = _script_of(cp)
        if s:
            script_counts[s] += 1
    non_latin = sum(script_counts.values())
    if non_latin >= max(2, latin):
        top, n = script_counts.most_common(1)[0]
        conf = n / non_latin
        # Japanese text mixes kana + han; any kana decides ja
        if top in ("han", "kana"):
            return ({"ja": conf} if script_counts.get("kana", 0) > 0
                    else {"zh": conf})
        if top == "arabic":
            lo = text
            if any(c in lo for c in _ARABIC_UR):
                return {"ur": conf}
            if any(c in lo for c in _ARABIC_FA):
                return {"fa": conf}
            return {"ar": conf}
        if top == "hebrew":
            # Yiddish uses the Hebrew script with digraph letters (װ ײ ױ)
            # and pointed alef (אַ אָ) as ordinary letters. Pointed alef
            # alone is NOT Yiddish evidence when the text carries the
            # rest of the niqqud inventory (shva/hiriq/tsere/…): that is
            # vocalized HEBREW (prayer books, children's text), which
            # Yiddish orthography never uses
            other_niqqud = sum(
                text.count(c) for c in
                "ְֱֲֳִֵֶֹֻ")
            if (sum(text.count(c) for c in "װײױ") >= 1
                    or (text.count("אַ") + text.count("אָ") >= 2
                        and other_niqqud == 0)):
                return {"yi": conf}
            return {"he": conf}
        if top == "devanagari":
            # hi / mr / ne share the script — profile + marker scoring
            out = _softmax_top(
                _score_profiles(text, _DEVANAGARI_LANGS),
                n_words=len(_word_re.findall(text)))
            return out or {"hi": conf}
        if top == "cyrillic":
            lo = text.lower()
            for lang in ("uk", "be", "sr", "mk"):
                marks = _CYR_MARKERS[lang]
                if marks and sum(lo.count(c) for c in marks) >= 2:
                    # і is shared by uk/be: ў decides be
                    if lang == "uk" and "ў" in lo:
                        continue
                    return {lang: conf}
            # ы/э exist ONLY in Russian and Belarusian (ў decides be)
            if "ы" in lo or "э" in lo:
                return {("be" if "ў" in lo else "ru"): conf}
            # ъ/щ without ы/э → Bulgarian (Russian's ы is ubiquitous,
            # Bulgarian dropped it; Serbian/Macedonian never use ъ)
            if (lo.count("ъ") + lo.count("щ")) >= 2:
                return {"bg": conf}
            # character-inventory exclusion before profile scoring
            # (the Optimaize unigram-table idea): sentence-length
            # Ukrainian prose essentially always contains і/ї/є (і is
            # the conjunction "and"), Belarusian always ў or і — their
            # ABSENCE rules those languages out far more reliably than
            # a close trigram race decides between them
            cands = list(_CYRILLIC_LANGS)
            if non_latin >= 20:
                if not any(c in lo for c in "іїєґ"):
                    cands.remove("uk")
                if not any(c in lo for c in "ўі"):
                    cands.remove("be")
            scores = _score_profiles(lo, cands)
            return _softmax_top(scores, n_words=len(_word_re.findall(lo)))
        return {top: conf}  # dedicated script
    if latin == 0:
        return {}
    return _softmax_top(_score_profiles(text, _LATIN_LANGS),
                        n_words=len(_word_re.findall(text)))


def detect(text: Optional[str]) -> Optional[str]:
    """Best language code, or None."""
    d = detect_language(text)
    return next(iter(d)) if d else None


def stopwords_for(lang: Optional[str]) -> frozenset:
    """Per-language function-word set (used by TextTokenizer's
    language-aware analysis, the Lucene per-language stopword filter
    analogue); empty set for unknown languages."""
    return _STOPWORDS.get(lang or "", frozenset())
